"""Device selection shared by every entry point of the port.

Counterpart of ``flink_tensorflow_tpu/utils/platform.py``: the port runs
on the GPU unless the caller asks for the CPU.  There is no silent
fallback — a missing card is an error, so a measurement can never be a
CPU number under a device name.
"""

from __future__ import annotations

import typing

import torch


def resolve_device(device: typing.Union[None, str, torch.device] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises if CUDA is absent); ``"cpu"`` or any
    explicit device is returned as a ``torch.device`` (a CUDA one is
    checked for availability too)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
