"""Weights from the seed, made on the device, handed to both sides.

The reference module of a configuration is built without storage, put on
the device, and filled in a few large calls from one ``torch.Generator``
on that device: every conv and dense kernel from one normal draw, scaled
per tensor to He's ``sqrt(2 / fan_in)`` (``sqrt(1 / fan_in)`` for the
dense head, whose output is not rectified), every norm's scale 1 and
shift 0, running mean 0 and variance 1, biases 0.  The same seed gives
the same bits, so the check after the window makes them again rather
than keeping a copy beside the program through the window.

The program's module gets the same tensors: its parameters and buffers
are paired with the reference's in order, every shape checked.

A configuration whose file says ``"weights": "per_tensor"`` (a model
that does not fit on the card twice in float32) is made one tensor at a
time instead: the i-th parameter of the reference's order from a
generator of its own, seeded by ``derive(seed, TENSOR_SALT + i)``, at
the same scales, and rounded to the configuration's ``compute_dtype``
as it is made.  The program's module is filled in place
with no copy of the whole model beside it, and after the window the
reference makes any part of itself again, alone
(``reference_tensors``), with the values the program held, widened to
float32.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from benchmark.reference import module_for

def derive(seed: int, salt: int) -> int:
    """A 63-bit seed from ``(seed, salt)``."""
    return int(np.random.SeedSequence([int(seed), salt]).generate_state(1, np.uint64)[0] >> 1)


def reference_class(config: typing.Mapping[str, typing.Any]) -> type:
    """The configuration's reference class (its ``reference``'s
    ``module`` under ``reference/`` and ``class``)."""
    ref = config["reference"]
    return getattr(module_for(ref["module"]), ref["class"])


def reference_kwargs(config: typing.Mapping[str, typing.Any]) -> typing.Dict[str, typing.Any]:
    """The keyword arguments the configuration builds its reference with."""
    return dict(config["reference"].get("kwargs", {}))


#: Added to a parameter's index for the seed of its own generator, so
#: per-tensor draws stay apart from the harness's other salts.
TENSOR_SALT = 1 << 20

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def per_tensor(config: typing.Mapping[str, typing.Any]) -> bool:
    """Whether the configuration's weights are made one tensor at a time."""
    return config.get("weights") == "per_tensor"


def weights_dtype(config: typing.Mapping[str, typing.Any]) -> torch.dtype:
    """The dtype a per-tensor configuration's kernels are rounded to: its
    compute dtype, which the program holds them in."""
    return _DTYPES[config["compute_dtype"]]


def _gain(shape: typing.Sequence[int]) -> float:
    return math.sqrt((1.0 if len(shape) == 2 else 2.0) / math.prod(shape[1:]))


def _vector(name: str) -> float:
    """A vector parameter's value: a norm's scale 1, anything else 0."""
    return 1.0 if name.endswith("gamma") else 0.0


def _meta_reference(config: typing.Mapping[str, typing.Any]) -> torch.nn.Module:
    with torch.device("meta"):
        return reference_class(config)(**reference_kwargs(config))


def fill_per_tensor(items: typing.Iterable[typing.Tuple[int, str, torch.Tensor]], seed: int,
                    dtype: torch.dtype) -> None:
    """Fill each ``(index, reference name, tensor)`` in place: a kernel
    (two or more dimensions) from its own generator on the tensor's
    device, drawn in float32, scaled and rounded to ``dtype`` (once,
    where the tensor is of ``dtype``: no other copy is made; a wider
    tensor gets the rounded values widened); a vector its constant.  The
    values depend on ``(seed, index)`` alone, not on the order of
    ``items``."""
    with torch.no_grad():
        for index, name, dst in items:
            if dst.dim() < 2:
                dst.fill_(_vector(name))
                continue
            if dst.dtype not in (dtype, torch.float32):
                raise ValueError(f"{name}: a {dst.dtype} tensor cannot hold the "
                                 f"configuration's {dtype} weights")
            gen = torch.Generator(dst.device).manual_seed(derive(seed, TENSOR_SALT + index))
            draw = torch.randn(dst.shape, generator=gen, device=dst.device)
            draw.mul_(_gain(dst.shape))
            dst.copy_(draw if dst.dtype == dtype else draw.to(dtype))
            # Freed before the next draw is made, so at most one lives.
            del draw


def _fill_buffers(named: typing.Iterable[typing.Tuple[str, torch.Tensor]]) -> None:
    """Running variances 1, every other buffer 0."""
    with torch.no_grad():
        for name, b in named:
            b.fill_(1.0 if name.endswith("var") else 0.0)


def reference_tensors(config: typing.Mapping[str, typing.Any], seed: int,
                      device: torch.device,
                      select: typing.Callable[[str], bool]) -> typing.Dict[str, torch.Tensor]:
    """A per-tensor configuration's reference parameters whose names
    ``select`` takes, each made alone as the program held it, in float32:
    so the reference can run one layer at a time after the window."""
    named = [(i, name, p) for i, (name, p) in enumerate(_meta_reference(config)
                                                       .named_parameters()) if select(name)]
    out = {name: torch.empty(p.shape, device=device) for _, name, p in named}
    fill_per_tensor([(i, name, out[name]) for i, name, _ in named], seed, weights_dtype(config))
    return out


def reference_module(config: typing.Mapping[str, typing.Any], seed: int,
                     device: torch.device) -> torch.nn.Module:
    """The configuration's reference module with the seed's weights."""
    module = _meta_reference(config).to_empty(device=device)
    if per_tensor(config):
        fill_per_tensor([(i, name, p) for i, (name, p) in enumerate(module.named_parameters())],
                        seed, weights_dtype(config))
        _fill_buffers(module.named_buffers())
        return module
    kernels = [p for p in module.parameters() if p.dim() >= 2]
    vectors = {id(p) for p in kernels}
    gen = torch.Generator(device).manual_seed(derive(seed, 11))
    with torch.no_grad():
        sizes = [p.numel() for p in kernels]
        draw = torch.randn(sum(sizes), generator=gen, device=device)
        gains = [_gain(p.shape) for p in kernels]
        draw *= torch.repeat_interleave(torch.tensor(gains, device=device),
                                        torch.tensor(sizes, device=device))
        torch._foreach_copy_(kernels, [c.view_as(p) for c, p in
                                       zip(torch.split(draw, sizes), kernels)])
        for name, p in module.named_parameters():
            if id(p) not in vectors:
                p.fill_(_vector(name))
    _fill_buffers(module.named_buffers())
    return module


def into_program(config: typing.Mapping[str, typing.Any], target: torch.nn.Module, seed: int,
                 device: torch.device) -> torch.nn.Module:
    """``target`` (the program's module) with the seed's weights: the
    reference's, made and copied in order, or for a per-tensor
    configuration made in place, paired with the reference's names and
    shapes."""
    if not per_tensor(config):
        return load_into(target, reference_module(config, seed, device))
    ref = _meta_reference(config)
    names = [n for n, _ in ref.named_parameters()]
    params = list(target.parameters())
    pair(list(ref.parameters()), params, "parameters")
    pair(list(ref.buffers()), list(target.buffers()), "buffers")
    fill_per_tensor(list(zip(range(len(params)), names, params)), seed, weights_dtype(config))
    _fill_buffers(zip((n for n, _ in ref.named_buffers()), target.buffers()))
    return target


def pair(src: typing.Sequence[torch.Tensor], dst: typing.Sequence[torch.Tensor],
         what: str) -> None:
    if len(src) != len(dst) or any(a.shape != b.shape for a, b in zip(src, dst)):
        raise ValueError(f"the reference's {what} do not pair with the program's: "
                         f"{[tuple(t.shape) for t in src][:8]} ... against "
                         f"{[tuple(t.shape) for t in dst][:8]} ...")


def load_into(target: torch.nn.Module, ref: torch.nn.Module) -> torch.nn.Module:
    """``target`` (the program's module) with ``ref``'s tensors, in order."""
    src_p, dst_p = list(ref.parameters()), list(target.parameters())
    src_b, dst_b = list(ref.buffers()), list(target.buffers())
    pair(src_p, dst_p, "parameters")
    pair(src_b, dst_b, "buffers")
    with torch.no_grad():
        torch._foreach_copy_(dst_p + dst_b, src_p + src_b)
    return target

