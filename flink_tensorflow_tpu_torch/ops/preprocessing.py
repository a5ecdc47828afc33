"""Image preprocessing on the device, inside the model call.

Port of ``flink_tensorflow_tpu/ops/preprocessing.py``.  Records ship uint8
pixels (4x fewer host->device bytes than float32) and the cast and affine
transform run on the device next to the first convolution.  The reference
computes ``x.astype(dtype) * scale + offset`` with the Python scalars
weakly typed, so each scalar is first rounded to ``dtype`` and each op
rounds to ``dtype``; the port rounds the scalars the same way.  Batches
are NHWC, as the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def normalize_image(x: torch.Tensor, *, scale: float, offset: float,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Cast and affine-normalize an image batch (any layout) in ``dtype``."""
    return x.to(dtype) * _rounded(scale, dtype) + _rounded(offset, dtype)


def inception_normalize(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inception's ``x/127.5 - 1`` transform (uint8 -> [-1, 1])."""
    return normalize_image(x, scale=1.0 / 127.5, offset=-1.0, dtype=dtype)


def mnist_normalize(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """MNIST's ``x/255`` transform (uint8 -> [0, 1])."""
    return normalize_image(x, scale=1.0 / 255.0, offset=0.0, dtype=dtype)


def central_crop(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Central crop of an NHWC batch (a view; the shape is static)."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    h, w = x.shape[-3], x.shape[-2]
    # round(), not int(): 100 * 0.29 is an epsilon below 29 in binary,
    # and truncation would crop one row short (JAX ``:53-55``).
    ch, cw = max(1, round(h * fraction)), max(1, round(w * fraction))
    top, left = (h - ch) // 2, (w - cw) // 2
    return x[..., top:top + ch, left:left + cw, :]


def resize_bilinear(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """Bilinear resize of an NHWC batch to ``size=(H, W)``.

    ``jax.image.resize(method="bilinear")`` samples at half-pixel centres
    and widens its triangle kernel by the scale when it shrinks
    (antialiasing); ``F.interpolate`` with ``align_corners=False`` and
    ``antialias=True`` does both.  A float batch keeps its dtype (a
    16-bit one is resized in float32 and rounded back once); an integer
    one comes back as float32, unrounded, as the reference's."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    nchw = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    wide = nchw.dtype in (torch.float32, torch.float64)
    out = F.interpolate(nchw if wide else nchw.float(), size=(int(size[0]), int(size[1])),
                        mode="bilinear", align_corners=False, antialias=True)
    if x.is_floating_point() and not wide:
        out = out.to(x.dtype)
    return out.permute(0, 2, 3, 1).reshape(lead + (int(size[0]), int(size[1]), c))
