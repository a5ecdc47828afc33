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

Over a mesh that spans a cohort (``parallel/mesh.py``) the gang's step
is the JAX ``jit`` over a batch sharded on ``data``, spelled out: each
rank runs the forward and backward pass on its own rows, with train-mode
batch norm's moments averaged over the data axis inside the pass
(``collectives.cross_replica_moments``: the reference's BN sees the
GLOBAL batch, and so must its running statistics), each rank's loss
weighted by its share of the valid rows; the gradients and the metrics
are then averaged over the axis (one all-reduce), and every rank takes
the same optimizer step, so the state stays replicated.  At one rank every
collective is a copy and every weight 1, so the step keeps its bits.

``rng``: the state keeps an integer seed and each step derives a
``torch.Generator`` on the state's device from ``(seed, step)`` (what
Inception's dropout draws from) — the snapshot stays plain data.  The reference's jitted step
donates its state (``donate_argnums=(0,)``); the port's form of that is
an in-place update of the state's tensors (``inplace=True``, what
:func:`make_dp_train_step` builds), so a snapshot of such a state must
copy it.
"""

from __future__ import annotations

import contextlib
import typing

import numpy as np
import torch
from torch import nn

from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef
from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
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


def make_train_step(model_def: ModelDef, optimizer, *, inplace: bool = False,
                    data_group: typing.Optional[typing.Tuple[typing.Any, int]] = None):
    """``step(state, batch, step_no=None) -> (state, metrics)``, one SGD
    step.  ``batch`` is a dict of tensors on the state's device; metrics
    stay there (0-d tensors).  ``step_no`` is the host's count of steps
    already taken (the operators keep one); without it the step reads
    ``state["step"]``, which waits for the device.

    ``inplace=False`` returns a new state and leaves the old one intact
    (the online operator pipelines steps and keeps older states);
    ``inplace=True`` updates the given state's tensors and returns it.

    ``data_group=(group, n)``: this rank's share of a step over ``n``
    ranks (see the module docstring)."""
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
        # A meta state (the plan-time pricer's) draws from a host generator.
        gen_device = leaves[0].device if leaves[0].device.type != "meta" else "cpu"
        generator = torch.Generator(gen_device).manual_seed(fold_in(state["rng"], step_no))
        weight = None if data_group is None else _rank_weight(data_group, batch, leaves[0])
        with torch.enable_grad(), _moments(data_group):
            loss, (new_model_state, metrics) = torch.func.functional_call(
                skeleton, tensors, (batch, generator))
            if weight is not None:
                loss = loss * weight
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data_group is not None:
            _average(data_group, weight, grads, metrics)
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


def _moments(data_group):
    if data_group is None:
        return contextlib.nullcontext()
    return collectives.cross_replica_moments(*data_group)


def _rank_weight(data_group, batch, like: torch.Tensor) -> torch.Tensor:
    """``w_r = n c_r / sum_r c_r`` for this rank's count ``c_r`` of valid
    rows (one all-reduce).  The JAX loss is the valid-weighted mean over
    the global batch, ``sum_r c_r L_r / sum_r c_r`` for per-rank means
    ``L_r``: each rank differentiates ``w_r L_r``, and the mean over the
    ranks of those gradients is that loss's gradient, batch norm's
    cross-rank terms included.  With equal counts every weight is
    exactly 1."""
    group, n = data_group
    valid = batch.get("valid")
    rows = next(iter(batch.values())).shape[0]
    count = (valid.float().sum() if valid is not None
             else torch.tensor(float(rows), device=like.device))
    total = collectives.all_reduce_(count.clone(), group)
    return count * n / total


def _average(data_group, weight: torch.Tensor, grads: dict, metrics: dict) -> None:
    """Gradients (of the weighted loss) and metrics in place: their mean
    over the data axis, the metrics weighted as the loss is."""
    group, n = data_group
    torch._foreach_mul_(list(metrics.values()), weight)
    collectives.all_reduce_mean_(list(grads.values()) + list(metrics.values()), group, n)


def make_dp_train_step(model_def: ModelDef, optimizer, mesh: Mesh):
    """The gang's step over a mesh: this process's rows on its device,
    state replicated, updated in place (the reference's donated state).
    On a one-device mesh it is :func:`make_train_step`; over a cohort
    (``mesh.distributed``) the batch is split over ``data`` and the step
    runs the collectives of the module docstring.  Other axes must have
    size 1: the batch rides ``data`` only."""
    if not mesh.distributed:
        return make_train_step(model_def, optimizer, inplace=True)
    others = {a: s for a, s in mesh.shape.items() if a != DATA_AXIS and s > 1}
    if others:
        raise ValueError(f"make_dp_train_step splits the batch over {DATA_AXIS!r} only; "
                         f"mesh axes {others} would hold replicas of the same rows")
    return make_train_step(model_def, optimizer, inplace=True,
                           data_group=(mesh.group(DATA_AXIS), mesh.axis_size(DATA_AXIS)))
