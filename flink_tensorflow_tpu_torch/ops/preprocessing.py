"""Image normalization on the device, inside the model call.

Port of ``flink_tensorflow_tpu/ops/preprocessing.py:inception_normalize``
(``:34``).  Records ship uint8 pixels (4x fewer host->device bytes than
float32) and the cast and affine transform run on the device next to the
first convolution.  The reference computes ``x.astype(dtype) * scale +
offset`` with the Python scalars weakly typed, so each scalar is first
rounded to ``dtype`` and each op rounds to ``dtype``; the port rounds the
scalars the same way.
"""

from __future__ import annotations

import torch


def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def inception_normalize(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inception's ``x/127.5 - 1`` transform (uint8 -> [-1, 1]) of an image
    batch in any layout, computed in ``dtype``."""
    return x.to(dtype) * _rounded(1.0 / 127.5, dtype) + _rounded(-1.0, dtype)
