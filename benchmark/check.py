"""The comparison that decides ``correct``.

Inference cells: a sample of the records whose results reached the sink
inside the window, drawn from the seed, each matched to its own record
id, is run through the reference on the same pixels and weights.  Two
numbers, each per record over the reference's logits, the worst record
taken:

- ``logit_err``: the largest gap between a served logit and the
  reference's, over the spread (standard deviation) of the reference's
  logits of that record;
- ``label_gap``: how far the reference's logit of the served label lies
  below the reference's best, over the same spread (0 where they agree).

Training cells: the set-up drives the program's train step through its
first windows; the reference takes the same steps from the same weights
on the same batches and dropout draws.  The numbers:

- ``loss_gap``: the largest gap between a step's loss and the
  reference's, over the reference's, over the first steps;
- ``grad_gap``: the first gradient, as the optimizer got it (adam's first
  moment after one step over ``1 - b1``), per leaf the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf: the median leaf's gap.  The
  worst leaf's is printed beside it but not compared: in bfloat16 the
  gradients of the early batch norms' scales and shifts are small
  remainders of large sums that cancel, and a plain reference fed
  bfloat16 operands reads them 10-30% off as the program does
  (``PERF.md``), on every seed;
- ``update_gap``: the gap of norms of the parameters' change over the
  first steps, the worst leaf (a leaf left unmoved, or moved twice,
  reads about 1);
- ``moments_err``: the first step's batch-norm moments, which the
  program's state carries in its running statistics after one step
  (``running = m * initial + (1 - m) * batch``, the momentum ``m`` from
  the configuration), against the reference's: the median norm's error
  (``moments_errs``).  This is the number the lower precision fails: the
  gaps of norms above read the rounding of either precision alike
  (``PERF.md``).  The worst norm's is shown beside it: the deepest
  norms' moments carry the error of every layer before them in either
  precision.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under adam by round-off alone and are left out of the
gradient's and the change's numbers.  A record or step that never came
back, or came back twice, is a failure in itself (``failed``).
"""

from __future__ import annotations

import typing

import numpy as np
import torch
import torch.nn.functional as F

#: Leaves whose reference gradient norm is under this share of the
#: median leaf's are left out.
DEAD_LEAF = 1e-3


def fold_in(seed: int, data: int) -> int:
    """The step's dropout seed from the state's seed and the step number:
    a frozen copy of the program's ``parallel/dp.py:fold_in``, which the
    benchmark hands both sides (the state's ``rng``)."""
    return int(np.random.SeedSequence([int(seed) & (2**63 - 1), int(data)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


# -- inference ----------------------------------------------------------------

def reference_logits(ref: torch.nn.Module, pixels: np.ndarray, device: torch.device, *,
                     arith=None, block: int = 32) -> np.ndarray:
    """``[N, classes]`` float32 logits of the reference, in blocks."""
    out = []
    with torch.no_grad():
        for i in range(0, len(pixels), block):
            x = torch.from_numpy(np.ascontiguousarray(pixels[i:i + block])).to(device)
            out.append(ref(x, arith=arith).float().cpu().numpy())
    return np.concatenate(out)


def forward_numbers(ref_logits: np.ndarray, logits: np.ndarray,
                    labels: np.ndarray) -> typing.Dict[str, float]:
    spread = ref_logits.std(axis=1)
    err = np.abs(logits - ref_logits).max(axis=1) / spread
    best = ref_logits.max(axis=1)
    gap = (best - ref_logits[np.arange(len(labels)), labels]) / spread
    return {"logit_err": float(err.max()), "label_gap": float(gap.max())}


# -- training -----------------------------------------------------------------

def reference_steps(ref: torch.nn.Module, batches, *, rng: int, lr: float, b1: float,
                    b2: float, eps: float, device: torch.device, arith=None):
    """Adam steps of the reference in float32 over ``batches`` (``[(pixels
    uint8, labels)]``).  Returns ``(losses, first gradient, parameters
    after, the first step's batch moments)``: the gradient and parameters
    in ``ref.parameters()`` order, the moments ``(mean, variance)`` of
    each norm in ``ref.modules()`` order."""
    params = [p.detach().clone().requires_grad_() for p in ref.parameters()]
    names = [n for n, _ in ref.named_parameters()]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first, moments = [], None, {}
    for k, (pixels, labels) in enumerate(batches):
        x = torch.from_numpy(np.ascontiguousarray(pixels)).to(device)
        y = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
        gen = torch.Generator(device).manual_seed(fold_in(rng, k))
        logits = torch.func.functional_call(
            ref, dict(zip(names, params)), (x,),
            {"train": True, "generator": gen, "arith": arith,
             "moments": moments if k == 0 else None})
        loss = F.cross_entropy(logits.float(), y)
        grads = torch.autograd.grad(loss, params)
        losses.append(loss.item())
        if first is None:
            first = [g.detach().clone() for g in grads]
        with torch.no_grad():
            t = k + 1
            for p, g, mk, vk in zip(params, grads, m, v):
                mk.mul_(b1).add_(g, alpha=1 - b1)
                vk.mul_(b2).addcmul_(g, g, value=1 - b2)
                p -= lr * (mk / (1 - b1 ** t)) / (torch.sqrt(vk / (1 - b2 ** t)) + eps)
    return (losses, first, [p.detach() for p in params],
            [moments[m] for m in ref.modules() if m in moments])


def _norms(tensors) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.double().cpu())) for t in tensors])


def leaf_gaps(prog: np.ndarray, ref: np.ndarray, counted: np.ndarray) -> np.ndarray:
    """Each counted leaf's gap of norms over the larger of its reference
    norm and the median leaf's."""
    floor = np.median(ref[counted])
    return (np.abs(prog - ref) / np.maximum(ref, floor))[counted]


def moments_errs(prog, ref) -> np.ndarray:
    """Each norm's error of the first step's batch moments: per channel
    the mean's error over the reference's standard deviation and half the
    variance's relative error, root mean square over channels.  These are
    statistics of the forward activations, so they see the precision the
    forward pass ran in."""
    out = []
    for (pm, pv), (rm, rv) in zip(prog, ref):
        rv = rv.double().cpu().clamp(min=1e-12)
        e = ((pm.double().cpu() - rm.double().cpu()) ** 2 / rv
             + ((pv.double().cpu() - rv) / (2 * rv)) ** 2)
        out.append(float(e.mean().sqrt()))
    return np.array(out)


def train_numbers(prog_losses, ref_losses, prog_grad, ref_grad, prog_delta,
                  ref_delta, prog_moments, ref_moments) -> typing.Dict[str, float]:
    """Every number of a training check; the cell's limits say which are
    compared, and the rest are printed beside them."""
    ref_g = _norms(ref_grad)
    counted = ref_g >= DEAD_LEAF * np.median(ref_g)
    loss = np.abs(np.asarray(prog_losses) - np.asarray(ref_losses)) / np.abs(ref_losses)
    grads = leaf_gaps(_norms(prog_grad), ref_g, counted)
    moments = moments_errs(prog_moments, ref_moments)
    return {"loss_gap": float(loss.max()), "grad_gap": float(np.median(grads)),
            "update_gap": float(leaf_gaps(_norms(prog_delta), _norms(ref_delta),
                                          counted).max()),
            "moments_err": float(np.median(moments)),
            "moments_err_worst_norm": float(moments.max()),
            "grad_gap_worst_leaf": float(grads.max()),
            "leaves_left_out": float((~counted).sum())}


# -- the verdict --------------------------------------------------------------

def verdict(numbers: typing.Mapping[str, float], limits: typing.Mapping[str, float],
            failed: int) -> typing.Tuple[bool, typing.Dict[str, typing.Any],
                                         typing.Dict[str, float]]:
    """``correct``, each compared number (those ``limits`` names) beside
    its limit, and the numbers read but not compared."""
    if not limits:
        raise ValueError("a check with no limit compares nothing")
    shown: typing.Dict[str, typing.Any] = {"failed": {"value": failed, "limit": 0}}
    ok = failed == 0
    for name, limit in limits.items():
        value = numbers[name]
        shown[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, shown, {k: v for k, v in numbers.items() if k not in limits}
