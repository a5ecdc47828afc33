"""Flash attention — the prefill's attention, as a hand-written CUDA kernel.

Port of ``flink_tensorflow_tpu/ops/flash_attention.py``.  The TPU kernel
(``_build_flash_call``, a Pallas grid) becomes ``csrc/flash_attention.cu``
(K1), built with nvcc for ``sm_90a`` and called through ``ctypes``.  Next
to it lives its plain PyTorch version, :func:`flash_attention_reference`,
which the CPU tests hold against the JAX function and which the kernel is
held against on the card.

:func:`flash_attention` launches the kernel for a CUDA tensor and runs
the plain version only for a CPU tensor; it never falls back.  Each
launch adds one to ``flash_attention.launches``.

:func:`flash_attention_decode` (one query per row over a cache) is plain
PyTorch, as it is plain jnp in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

KERNEL_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              return_lse: bool = False):
    """Plain PyTorch attention over ``[B, T, H, D]`` with the kernel's
    semantics: f32 arithmetic, scale ``1/sqrt(D)``, causal mask
    ``k_pos <= q_pos`` aligned top-left, rows with nothing visible give
    ``o = 0`` and ``lse = -inf``.  ``lse`` is ``[B, H, T]`` f32."""
    b, t, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    if causal:
        q_pos = torch.arange(t, device=q.device)[:, None]
        k_pos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    if tk == 0:
        m = torch.full((b, h, t), float("-inf"), device=q.device)
    else:
        m = s.amax(dim=-1)
    safe_m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isinf(s), torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    denom = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhts,bshd->bthd", p, v.float())
    out = (out / denom.permute(0, 2, 1)[..., None]).to(q.dtype)
    if return_lse:
        lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                          safe_m + torch.log(denom))
        return out, lse
    return out


def _check_kernel_inputs(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {x.device}, the kernel takes cuda")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, T, H, D], got {tuple(x.shape)}")
        if x.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: dtype {x.dtype} not supported by the kernel")
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one device")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid limit 65535")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from flink_tensorflow_tpu_torch.ops._build import load_library

    fn = load_library(KERNEL_SOURCE).ftt_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_int64] * 9 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _kernel(q, k, v, causal: bool):
    fn = _kernel_fn()
    b, t, h, d = q.shape
    tk = k.shape[1]
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             _DTYPES[q.dtype], b, h, t, tk, d,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q, k, v, *, causal: bool = False, return_lse: bool = False):
    """Attention over ``[B, T, H, D]`` tensors (``k``/``v``: ``[B, Tk, H,
    D]``).  Returns ``o`` ``[B, T, H, D]`` in the input dtype, plus
    ``lse`` ``[B, H, T]`` f32 with ``return_lse=True``.

    A CUDA tensor launches K1 (f32, bf16 or f16; D in 16/32/64/128;
    last dim contiguous, any other strides) or raises; a CPU tensor runs
    :func:`flash_attention_reference`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, return_lse=return_lse)
    _check_kernel_inputs(q, k, v)
    o, lse = _kernel(q, k, v, causal)
    return (o, lse) if return_lse else o


#: Kernel launches since the last reset (set to 0 by callers that count).
flash_attention.launches = 0


def flash_attention_decode(q, k, v, lengths=None, *, return_lse: bool = False):
    """Single-step decode attention: one query per row over a cache.

    ``q``: ``[B, 1, H, D]`` (or ``[B, H, D]``); ``k``/``v``: ``[B, C, H,
    D]``; ``lengths``: ``[B]`` valid cached positions per row (positions
    ``>= lengths[b]`` are masked).  Returns ``[B, 1, H, D]`` (``[B, H,
    D]`` for 3-D q) in q's dtype, plus ``lse`` ``[B, H, 1]`` f32 with
    ``return_lse=True``.  Rows with ``lengths == 0`` give zeros and
    ``lse = -inf``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, tq, h, d = q.shape
    if tq != 1:
        raise ValueError(
            f"flash_attention_decode takes exactly one query step, got T={tq}; "
            "use flash_attention for prefill")
    c = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale  # [B,H,1,C]
    if lengths is not None:
        valid = (torch.arange(c, device=q.device)[None, None, None, :]
                 < lengths.to(q.device)[:, None, None, None])
        s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1)                                 # [B,H,1]
    safe_m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isinf(s), torch.zeros_like(p), p)
    l = p.sum(dim=-1)                                  # [B,H,1]
    denom = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = (out / denom.permute(0, 2, 1)[..., None]).to(q.dtype)
    if squeeze:
        out = out[:, 0]
    if return_lse:
        lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                          safe_m + torch.log(denom))
        return out, lse
    return out
