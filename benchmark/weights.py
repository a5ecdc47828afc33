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


def reference_module(config: typing.Mapping[str, typing.Any], seed: int,
                     device: torch.device) -> torch.nn.Module:
    """The configuration's reference module with the seed's weights."""
    with torch.device("meta"):
        module = reference_class(config)(**reference_kwargs(config))
    module = module.to_empty(device=device)
    kernels = [p for p in module.parameters() if p.dim() >= 2]
    vectors = {id(p) for p in kernels}
    gen = torch.Generator(device).manual_seed(derive(seed, 11))
    with torch.no_grad():
        sizes = [p.numel() for p in kernels]
        draw = torch.randn(sum(sizes), generator=gen, device=device)
        gains = [math.sqrt((1.0 if p.dim() == 2 else 2.0) / p[0].numel()) for p in kernels]
        draw *= torch.repeat_interleave(torch.tensor(gains, device=device),
                                        torch.tensor(sizes, device=device))
        torch._foreach_copy_(kernels, [c.view_as(p) for c, p in
                                       zip(torch.split(draw, sizes), kernels)])
        for name, p in module.named_parameters():
            if id(p) not in vectors:
                p.fill_(1.0 if name.endswith("gamma") else 0.0)
        for name, b in module.named_buffers():
            b.fill_(1.0 if name.endswith("var") else 0.0)
    return module


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

