"""K1's launch plan (CPU) and the edges of the kernel itself (card only).

The plan tests check, without a card, what the CUDA source assumes of
its launch: shared memory within one H100 block's opt-in limit for every
(type, D), one TMA box per swizzle row, the grid for ragged T, and the
16-byte rule that TMA puts on pointers and strides.

The ``cuda`` tests hold the kernel to its plain version at the edges of
its design: T and Tk that are not multiples of the key tile, causal
masks with Tk < T and Tk > T, every D in f32, bf16 and f16, Tk = 0, q/k/v
as strided views of one ``[B, T, 3, H, D]`` tensor, and a misaligned
pointer, which must raise.  Tolerances: f32 atol 1e-4 (3xTF32 products,
another summation order); 16-bit outputs atol 3e-3 + rtol 2**-7, i.e. one
step of the output type plus the rounding of P to the input type before
P.V (at most 2**-9 of each weight, worst on rows that see 2-3 keys).
"""

import pytest
import torch

from flink_tensorflow_tpu_torch.ops import flash_attention as fa

_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_DIMS = (16, 32, 64, 128)


@pytest.mark.parametrize("dtype", sorted(_TYPES))
@pytest.mark.parametrize("d", _DIMS)
def test_plan_fits_shared_memory_and_swizzle(dtype, d):
    plan = fa.launch_plan(_TYPES[dtype], d)
    es = torch.tensor([], dtype=_TYPES[dtype]).element_size()
    assert plan.smem_bytes <= fa.SMEM_LIMIT == 232_448
    # q tile + K and V tiles per ring slot (+ in f32 the small tf32 part of
    # q and of one K tile, and V^T as big and small) + 1 KB alignment slack
    # + barriers (q, and K and V of each slot)
    split = dtype == "float32"
    tiles = ((1 + split) * plan.block_q + (2 * plan.stages + 3 * split) * plan.block_k) * d * es
    assert plan.smem_bytes == 1024 + tiles + 8 * (1 + 2 * plan.stages)
    # One warpgroup (128 threads) per 64 query rows: two in 16-bit at
    # D = 128, else one.
    assert plan.stages >= 2 and plan.threads == 2 * plan.block_q
    assert plan.block_q == (128 if not split and d == 128 else 64)
    # One box row is one swizzle span, at most 128 bytes; boxes tile D.
    assert plan.swizzle_bytes in (32, 64, 128)
    assert plan.swizzle_bytes == plan.box_cols * es <= 128
    assert plan.box_cols * plan.tma_boxes == d


@pytest.mark.parametrize("dtype,d,box,swizzle,boxes", [
    (torch.bfloat16, 16, 16, 32, 1), (torch.bfloat16, 32, 32, 64, 1),
    (torch.bfloat16, 64, 64, 128, 1), (torch.bfloat16, 128, 64, 128, 2),
    (torch.float32, 16, 16, 64, 1), (torch.float32, 64, 32, 128, 2),
    (torch.float32, 128, 32, 128, 4), (torch.float16, 128, 64, 128, 2)])
def test_plan_box_and_swizzle_per_head_dim(dtype, d, box, swizzle, boxes):
    plan = fa.launch_plan(dtype, d)
    assert (plan.box_cols, plan.swizzle_bytes, plan.tma_boxes) == (box, swizzle, boxes)


@pytest.mark.parametrize("dtype,t,tiles", [
    (torch.float32, 1, 1), (torch.float32, 16, 1), (torch.float32, 64, 1), (torch.float32, 65, 2),
    (torch.float32, 1000, 16), (torch.bfloat16, 2048, 16), (torch.float16, 129, 2)])
def test_plan_grid_covers_ragged_t(dtype, t, tiles):
    plan = fa.launch_plan(dtype, 128, b=3, h=5, t=t)
    assert plan.grid == (tiles, 15)
    assert (tiles - 1) * plan.block_q < t <= tiles * plan.block_q


def test_plan_rejects_what_has_no_instance():
    with pytest.raises(ValueError, match="head dim"):
        fa.launch_plan(torch.float32, 48)
    with pytest.raises(TypeError, match="not supported"):
        fa.launch_plan(torch.float64, 64)


def _aligned(n, dtype):
    """A CPU buffer whose element 0 sits on a 16-byte boundary."""
    es = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(n + 16, dtype=dtype)
    skip = (-buf.data_ptr() % 16) // es
    return buf[skip:skip + n]


def test_alignment_rule_accepts_contiguous_and_fused_qkv_views():
    for dtype in _TYPES.values():
        x = _aligned(2 * 8 * 3 * 4 * 16, dtype).view(2, 8, 3, 4, 16)
        assert fa.tma_misalignment(x[:, :, 0]) is None
        assert fa.tma_misalignment(x[:, :, 1]) is None  # offset 4*16 elements
        assert fa.tma_misalignment(_aligned(2 * 8 * 4 * 32, dtype).view(2, 8, 4, 32)) is None


def test_alignment_rule_rejects_misaligned_pointer_and_stride():
    x = _aligned(1 + 2 * 8 * 4 * 16, torch.float32)
    assert "not 16-byte aligned" in fa.tma_misalignment(x[1:].view(2, 8, 4, 16))
    # A time stride of 4*16 + 1 f32 elements is 260 bytes.
    y = _aligned(2 * 8 * 65, torch.float32).view(2, 8, 65)[..., :64].view(2, 8, 4, 16)
    assert "axis 1" in fa.tma_misalignment(y)


def test_alignment_rule_ignores_strides_of_length_one_axes():
    x = _aligned(4 * 16 + 4, torch.float32)
    # B = T = H = 1: every stride is free, only the pointer counts.
    one = torch.as_strided(x, (1, 1, 1, 16), (7, 3, 5, 1))
    assert fa.tma_misalignment(one) is None


# ---------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _check(q, k, v, causal):
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    ro, rl = fa.flash_attention_reference(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert o.shape == ro.shape and o.dtype == q.dtype and lse.shape == rl.shape
    tol, rtol = (1e-4, 0) if q.dtype == torch.float32 else (3e-3, 2 ** -7)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=rtol)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rl))
    fin = torch.isfinite(rl)
    torch.testing.assert_close(lse[fin], rl[fin], atol=1e-4, rtol=0)


def _rand(gen, dtype, *shape):
    return torch.randn(*shape, device="cuda", generator=gen).to(_TYPES[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_TYPES))
@pytest.mark.parametrize("d", _DIMS)
@pytest.mark.parametrize("causal,t,tk", [(True, 100, 37), (True, 70, 200), (False, 130, 65)],
                         ids=["causal_tk_lt_t", "causal_tk_gt_t", "ragged_full"])
def test_kernel_edges_match_plain_version(dtype, d, causal, t, tk):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(d + t)
    q, k, v = (_rand(gen, dtype, 2, n, 3, d) for n in (t, tk, tk))
    _check(q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_TYPES))
def test_kernel_without_keys_gives_zero_and_neg_inf(dtype):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = _rand(gen, dtype, 2, 20, 3, 64)
    empty = torch.zeros((2, 0, 3, 64), device="cuda", dtype=_TYPES[dtype])
    o, lse = fa.flash_attention(q, empty, empty, return_lse=True)
    torch.cuda.synchronize()
    assert not o.float().abs().max().item()
    assert torch.isneginf(lse).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_TYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_reads_strided_views_of_fused_qkv(dtype, causal):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    qkv = _rand(gen, dtype, 2, 90, 3, 4, 32)
    _check(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal)


@pytest.mark.cuda
def test_kernel_reads_head_major_views():
    """[B, H, T, D] storage seen as [B, T, H, D]: the head stride exceeds
    the time stride."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (_rand(gen, "bfloat16", 2, 4, 80, 64).transpose(1, 2) for _ in range(3))
    _check(q, k, v, True)


@pytest.mark.cuda
def test_kernel_rejects_misaligned_pointer():
    _card()
    flat = torch.zeros(1 + 2 * 16 * 2 * 16, device="cuda")
    q = flat[1:].view(2, 16, 2, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
def test_kernel_plan_matches_launch_plan():
    _card()
    for dtype in _TYPES.values():
        for d in _DIMS:
            p = fa.launch_plan(dtype, d)
            assert fa.kernel_plan(dtype, d) == (p.block_q, p.block_k, p.stages, p.threads,
                                                p.smem_bytes, p.box_cols, p.swizzle_bytes)
