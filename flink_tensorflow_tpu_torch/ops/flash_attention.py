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
import typing

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


#: Launch constants of ``csrc/flash_attention.cu`` (its ``Plan``).
WG_ROWS = 64        # query rows per warpgroup: one wgmma M
WIDE_WARPGROUPS = 2  # consumer warpgroups per CTA for bf16/f16 at D = 128 (else 1)
BLOCK_K_F32 = 32    # keys per K/V tile in f32 (q and K also keep small tf32 parts)
BLOCK_K_16 = 128    # keys per tile in bf16/f16 at D <= 64
BLOCK_K_16_WIDE = 64  # ... and at D = 128, where the O accumulator takes the room
STAGES = {2: 2, 4: 3}  # K/V ring slots (each filled by TMA), by element bytes
SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may opt into
TMA_ALIGN = 16      # bytes: base pointers and strides of TMA-mapped tensors
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


class LaunchPlan(typing.NamedTuple):
    """How K1 is launched for one call (mirrors the kernel's ``Plan``)."""

    block_q: int
    block_k: int
    stages: int
    threads: int
    smem_bytes: int     # dynamic shared memory: slack + q + ring (+ f32 split tiles) + mbarriers
    box_cols: int       # TMA box width in elements = one swizzle row
    swizzle_bytes: int  # TMA swizzle = wgmma layout: 32, 64 or 128 bytes
    grid: typing.Tuple[int, int]  # (q tiles, B * H)
    tma_boxes: int      # boxes per tile: D / box_cols


def launch_plan(dtype: torch.dtype, d: int, b: int = 1, h: int = 1, t: int = 1) -> LaunchPlan:
    """K1's launch plan for ``[b, t, h, d]`` queries of ``dtype``: tile
    sizes, grid, shared-memory bytes, and the TMA box and swizzle (one box
    row is one swizzle span: at most 128 bytes, so bf16 at D = 128 loads as
    two 64-column boxes)."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {dtype} not supported by the kernel")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    es = _ELEM_BYTES[dtype]
    box = d if d * es <= 128 else 128 // es
    wgs = WIDE_WARPGROUPS if es == 2 and d == 128 else 1
    bq = WG_ROWS * wgs
    bk = BLOCK_K_F32 if es == 4 else (BLOCK_K_16 if d <= 64 else BLOCK_K_16_WIDE)
    q_bytes, kv_bytes = bq * d * es, bk * d * es
    split = es == 4  # 3xTF32 keeps small q, small K and V^T in two parts
    stages = STAGES[es]
    smem = (1024 + q_bytes + stages * 2 * kv_bytes + split * (q_bytes + 3 * kv_bytes)
            + 8 * (1 + 2 * stages))
    return LaunchPlan(bq, bk, stages, 128 * wgs, smem, box, box * es,
                      (-(-t // bq), b * h), d // box)


def tma_misalignment(x: torch.Tensor) -> typing.Optional[str]:
    """Why TMA cannot map ``x`` ([B, T, H, D], last dim contiguous), or
    None: the base pointer and the byte stride of every axis longer than 1
    must be multiples of 16 bytes."""
    es = x.element_size()
    if x.data_ptr() % TMA_ALIGN:
        return f"data pointer {x.data_ptr():#x} is not {TMA_ALIGN}-byte aligned"
    for axis in range(3):
        if x.shape[axis] > 1 and (x.stride(axis) * es) % TMA_ALIGN:
            return (f"stride {x.stride(axis)} of axis {axis} is {x.stride(axis) * es} bytes, "
                    f"not a multiple of {TMA_ALIGN}")
    return None


def _check_kernel_inputs(q, k, v) -> None:
    """Everything the kernel does not take raises here, before a launch."""
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
    for name, x in (("q", q), ("k", k), ("v", v)):
        why = tma_misalignment(x)
        if why:
            raise ValueError(f"flash_attention: {name}: {why} (TMA needs it)")


@functools.lru_cache(maxsize=None)
def _library():
    from flink_tensorflow_tpu_torch.ops._build import load_library

    lib = load_library(KERNEL_SOURCE)
    fn = lib.ftt_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7
    plan = lib.ftt_flash_attention_plan
    plan.restype = ctypes.c_int
    plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    global _FN
    _FN = fn
    return lib


#: The launch function once the library is loaded (saves a cache lookup per call).
_FN = None


def kernel_plan(dtype: torch.dtype, d: int) -> typing.Tuple[int, ...]:
    """The built kernel's own plan for (dtype, d): (BQ, BK, stages,
    threads, shared-memory bytes, box columns, swizzle bytes).  Builds the
    library; for checking :func:`launch_plan` on the card."""
    out = (ctypes.c_int * 7)()
    err = _library().ftt_flash_attention_plan(_DTYPES[dtype], d, out)
    if err:
        raise ValueError(f"flash_attention: no kernel instance for {dtype}, D={d}")
    return tuple(out)


class _Layout(typing.NamedTuple):
    params: ctypes.Array  # int64 {dtype, B, H, Tq, Tk, D, strides of q, k, v, causal}
    address: int          # of params, as the C function takes it
    lse_shape: typing.Tuple[int, int, int]


def _layout(q, k, v, causal: bool) -> _Layout:
    """The kernel's parameters for one layout of q, k, v: checked once
    (raises on what the kernel does not take)."""
    _check_kernel_inputs(q, k, v)
    b, t, h, d = q.shape
    params = (ctypes.c_int64 * 16)(_DTYPES[q.dtype], b, h, t, k.shape[1], d, *q.stride()[:3],
                                   *k.stride()[:3], *v.stride()[:3], int(causal))
    return _Layout(params, ctypes.addressof(params), (b, h, t))


#: Layouts seen so far (see :func:`_kernel`).  A server sees a few (one
#: per prompt bucket and batch size); the bound only keeps a caller whose
#: every call brings a new shape from growing the dict without end.
_LAYOUTS: typing.Dict[tuple, _Layout] = {}
_MAX_LAYOUTS = 4096
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _kernel(q, k, v, causal: bool, return_lse: bool):
    """Launches K1.  Shapes, strides, dtypes and devices are checked once
    per layout (``_LAYOUTS``, which also keeps the packed parameters); per
    call only the data pointers are checked for TMA's 16-byte alignment.
    ``lse`` is allocated (and written) only when asked for."""
    key = (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
           q.dtype, k.dtype, v.dtype, q.device, k.device, v.device, causal)
    lay = _LAYOUTS.get(key)
    if lay is None:
        lay = _layout(q, k, v, causal)
        if len(_LAYOUTS) >= _MAX_LAYOUTS:
            _LAYOUTS.clear()
        _LAYOUTS[key] = lay
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) & (TMA_ALIGN - 1):
        _check_kernel_inputs(q, k, v)  # raises, naming the pointer
    # The kernel writes o as contiguous [B, T, H, D], whatever q's strides.
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    dev = q.device
    lse = torch.empty(lay.lse_shape, dtype=torch.float32, device=dev) if return_lse else None
    err = (_FN or _library().ftt_flash_attention_fwd)(
        qp, kp, vp, o.data_ptr(), None if lse is None else lse.data_ptr(), lay.address,
        _raw_stream(dev.index))
    if err:
        what = (f"cuTensorMapEncodeTiled refused a tensor map: CUresult {-err}" if err < 0
                else f"cudaError_t {err}")
        raise RuntimeError(f"flash_attention kernel launch failed: {what}")
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
    o, lse = _kernel(q, k, v, bool(causal), return_lse)
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
