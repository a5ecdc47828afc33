"""Training steps — the port of ``flink_tensorflow_tpu/parallel/dp.py``.

``TrainState`` is an explicit dict, as in the reference:
``{"variables": {"params": {name: tensor}, "batch_stats": {name:
tensor}}, "opt_state": ..., "step": int32 tensor, "rng": int}``, with the
module's ``state_dict`` names as keys.  That it is explicit is the point:
the state rides the operator snapshot protocol like any other state.

A step runs ``model_def.loss_fn`` on ONE module through
``torch.func.functional_call`` with the state's tensors, differentiates
with ``torch.autograd.grad`` with respect to ``params`` only, and takes
the new ``batch_stats`` from the loss's auxiliary output, as
``jax.grad(..., has_aux=True)`` does.  The module is a storage-free
skeleton on the ``meta`` device: every tensor it reads is the state's.

``rng``: neither zoo model draws random numbers, so the state keeps an
integer seed and each step derives a ``torch.Generator`` from ``(seed,
step)`` — the snapshot stays plain data.  The reference's jitted step
donates its state (``donate_argnums=(0,)``); the port's form of that is
an in-place update of the state's tensors (``inplace=True``, what
:func:`make_dp_train_step` builds), so a snapshot of such a state must
copy it.
"""

from __future__ import annotations

import typing

import numpy as np
import torch
from torch import nn

from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef
from flink_tensorflow_tpu_torch.parallel.mesh import Mesh
from flink_tensorflow_tpu_torch.parallel.optim import apply_updates

TrainState = typing.Dict[str, typing.Any]   # variables / opt_state / step / rng


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``(seed, data)`` (``jax.random.fold_in``'s
    role): the subtask index into a function's seed, the step into the
    state's."""
    return int(np.random.SeedSequence([int(seed) & (2**63 - 1), int(data)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def module_variables(module: nn.Module) -> typing.Dict[str, typing.Dict[str, torch.Tensor]]:
    """A module's tensors as the two collections of a TrainState."""
    return {"params": {n: p.detach() for n, p in module.named_parameters()},
            "batch_stats": {n: b.detach() for n, b in module.named_buffers()}}


def init_train_state(model_def: ModelDef, optimizer, seed: int) -> TrainState:
    """Fresh training state from the port's initialiser (host tensors;
    place on a device with ``parallel.mesh.replicate``)."""
    variables = module_variables(model_def.init_fn(seed))
    return {
        "variables": variables,
        "opt_state": optimizer.init(variables["params"]),
        "step": torch.zeros((), dtype=torch.int32),
        "rng": fold_in(seed, 1),
    }


def state_device(state: TrainState) -> torch.device:
    return next(iter(state["variables"]["params"].values())).device


class _LossCall(nn.Module):
    """Wraps a module so ``functional_call`` runs ``loss_fn`` on it."""

    def __init__(self, module: nn.Module, loss_fn: typing.Callable):
        super().__init__()
        self.module = module
        self.loss_fn = loss_fn

    def forward(self, batch, generator):
        return self.loss_fn(self.module, batch, generator)


def make_train_step(model_def: ModelDef, optimizer, *, inplace: bool = False):
    """``step(state, batch, step_no=None) -> (state, metrics)``, one SGD
    step.  ``batch`` is a dict of tensors on the state's device; metrics
    stay there (0-d tensors).  ``step_no`` is the host's count of steps
    already taken (the operators keep one); without it the step reads
    ``state["step"]``, which waits for the device.

    ``inplace=False`` returns a new state and leaves the old one intact
    (the online operator pipelines steps and keeps older states);
    ``inplace=True`` updates the given state's tensors and returns it."""
    loss_fn = model_def.loss_fn
    if loss_fn is None:
        raise ValueError(f"model {model_def.architecture} has no loss_fn")
    if model_def.make_module is None:
        raise ValueError(f"model {model_def.architecture} has no make_module")
    with torch.device("meta"):
        skeleton = _LossCall(model_def.make_module(), loss_fn)

    def step(state: TrainState, batch, step_no: typing.Optional[int] = None):
        variables = state["variables"]
        params = variables["params"]
        names = list(params)
        leaves = [p.detach().requires_grad_() for p in params.values()]
        tensors = {f"module.{n}": t for n, t in variables.get("batch_stats", {}).items()}
        tensors.update((f"module.{n}", t) for n, t in zip(names, leaves))
        if step_no is None:
            step_no = int(state["step"])
        generator = torch.Generator(leaves[0].device).manual_seed(fold_in(state["rng"], step_no))
        with torch.enable_grad():
            loss, (new_model_state, metrics) = torch.func.functional_call(
                skeleton, tensors, (batch, generator))
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            if inplace:
                optimizer.apply_(grads, state["opt_state"], params)
                for collection, new in new_model_state.items():
                    old = variables[collection]
                    torch._foreach_copy_([old[n] for n in new], list(new.values()))
                state["step"].add_(1)
                return state, metrics
            updates, opt_state = optimizer.update(grads, state["opt_state"], params)
            new_state = {
                "variables": {**variables, "params": apply_updates(params, updates),
                              **new_model_state},
                "opt_state": opt_state,
                "step": state["step"] + 1,
                "rng": state["rng"],
            }
        return new_state, metrics

    return step


def make_multi_train_step(model_def: ModelDef, optimizer):
    """``multi(state, stacked, step_no=None) -> (state, stacked_metrics)``:
    K sequential steps in one call (the reference's ``lax.scan``).  Batch
    leaves are ``[K, B, ...]``; metric leaves come back ``[K]``.  In torch
    this is exactly K single steps, bit for bit."""
    step = make_train_step(model_def, optimizer)

    def multi(state: TrainState, stacked, step_no: typing.Optional[int] = None):
        k = next(iter(stacked.values())).shape[0]
        if step_no is None:
            step_no = int(state["step"])
        rows = []
        for i in range(k):
            state, metrics = step(state, {n: v[i] for n, v in stacked.items()}, step_no + i)
            rows.append(metrics)
        return state, {n: torch.stack([r[n] for r in rows]) for n in rows[0]}

    return multi


def make_dp_train_step(model_def: ModelDef, optimizer, mesh: Mesh):
    """The gang's step over a mesh: batch on the mesh's data axis, state
    replicated, updated in place (the reference's donated state).  One
    device here; a multi-device mesh cannot be built yet
    (``parallel.mesh.make_mesh``)."""
    if len(mesh.devices) != 1:
        raise NotImplementedError("multi-device data parallelism is not ported yet")
    return make_train_step(model_def, optimizer, inplace=True)
