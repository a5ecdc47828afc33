#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. print the card's name and power limit (``nvidia-smi``); fail without CUDA;
2. build every kernel from ``flink_tensorflow_tpu_torch/csrc`` (one nvcc
   per source, started together) and print the build seconds;
3. hold K1 (flash attention) against its plain PyTorch version on the
   card at the serving shape and at larger shapes, and time kernel, plain
   version and ``scaled_dot_product_attention`` (a yardstick only, where
   Tk > 0) beside the bound of the route K1 takes (tensor cores for
   bf16/f16, 3xTF32 for f32; f32 rows also carry the FMA bound);
4. serve the repo's serving-bench configuration (char transformer
   64 wide x 3 layers, 96 requests from ``RandomState(11)``) through the
   port's subtask loop on the card, count K1's launches, and hold every
   session's tokens against a CPU run of the port on the same weights;
5. print one ``kernels`` JSON line, the card line, and the final
   ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores, TF32 and bf16/f16 on the tensor cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# (name, B, H, T, Tk, D, dtype, causal, return_lse)
K1_SHAPES = (
    ("serving", 8, 4, 16, 16, 16, "float32", True, False),
    ("long_f32", 4, 8, 2048, 2048, 64, "float32", True, False),
    ("long_bf16", 4, 8, 2048, 2048, 64, "bfloat16", True, False),
    ("long_f16_d128", 2, 16, 4096, 4096, 128, "float16", True, False),
    ("ragged_lse", 1, 4, 1000, 1536, 128, "float32", False, True),
    ("fully_masked", 1, 4, 16, 0, 16, "float32", False, True),
)
# (atol, rtol) of K1's output against its plain version.  f32: both sum
# f32 products (K1's from 3xTF32, about 21 bits) in another order.  16-bit:
# one step of the output type (rtol 2**-7 covers bf16's 2**-8) plus the
# rounding of P to the input type before P.V, at most 2**-9 of each weight,
# worst on rows that see 2-3 keys (atol 3e-3).  lse is f32 in every case
# and is held to 1e-4.
TOLERANCE = {"float32": (1e-4, 0.0), "bfloat16": (3e-3, 2 ** -7), "float16": (3e-3, 2 ** -7)}
LSE_TOLERANCE = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """(kernel instance, line) for each register / spill line of an nvcc
    -Xptxas -v log, the instance demangled by c++filt where it exists."""
    entry = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            try:
                entry = subprocess.run(["c++filt", entry], capture_output=True, text=True,
                                       timeout=10).stdout.strip() or entry
            except (OSError, subprocess.SubprocessError):
                pass
            entry = re.sub(r"\(.*\)$", "", entry.replace("(anonymous namespace)::", ""))
        elif "registers" in line or "spill" in line:
            yield entry, line.strip().replace("ptxas info    : ", "")


def time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound(b, h, t, tk, d, dtype, causal):
    """Least time for the work of this call on the route K1 takes: visible
    (q, k) pairs x 4D FLOPs at the route's peak (bf16/f16: tensor cores;
    f32: three TF32 products, 3x the FLOPs at the TF32 peak), or
    q+k+v+o+lse bytes at HBM rate.  Also returns the f32 FMA bound
    (FLOPs at 67 TFLOP/s), printed beside it for f32 rows."""
    pairs = sum(min(i + 1, tk) for i in range(t)) if causal else t * tk
    flops = 4 * b * h * d * pairs
    es = 4 if dtype == "float32" else 2
    nbytes = es * (2 * b * t * h * d + 2 * b * tk * h * d) + 4 * b * h * t
    if dtype == "float32":
        ops_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    else:
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    fma_ms = max(flops / PEAK_F32_FLOPS * 1e3, bytes_ms)
    bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return bound + (fma_ms,)


def check_k1(fa, torch):
    import torch.nn.functional as F

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, b, h, t, tk, d, dtype, causal, lse in K1_SHAPES:
        dt = getattr(torch, dtype)
        q = torch.randn(b, t, h, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dt)
        o, l = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        ro, rl = fa.flash_attention_reference(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        if o.shape != ro.shape or o.dtype != dt or l.shape != (b, h, t):
            fail(f"K1 {name}: shape/dtype {tuple(o.shape)} {o.dtype} {tuple(l.shape)}")
        if not torch.equal(torch.isinf(l), torch.isinf(rl)):
            fail(f"K1 {name}: -inf rows of lse differ")
        err = (o.float() - ro.float()).abs().max().item() if o.numel() else 0.0
        fin = torch.isfinite(rl)
        lse_err = (l[fin] - rl[fin]).abs().max().item() if fin.any() else 0.0
        if tk == 0 and (o.abs().max().item() != 0.0 or fin.any()):
            fail(f"K1 {name}: fully masked rows must give o = 0 and lse = -inf")
        atol, rtol = TOLERANCE[dtype]
        over = ((o.float() - ro.float()).abs() - rtol * ro.float().abs()).max().item() \
            if o.numel() else 0.0
        if not (over <= atol and lse_err <= LSE_TOLERANCE):
            fail(f"K1 {name}: max |o - plain| - rtol |plain| = {over} > {atol} "
                 f"or |lse - plain| {lse_err} > {LSE_TOLERANCE}")
        small = t * max(tk, 1) <= 1 << 16
        iters = 200 if small else 50
        plain_ms = time_ms(lambda: fa.flash_attention_reference(
            q, k, v, causal=causal, return_lse=lse), 200 if small else 5)
        # Kernel and library in turns, three times each; the medians are kept.
        kernel, library = [], []
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        for _ in range(3):
            kernel.append(time_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, return_lse=lse), iters))
            if tk > 0:
                # A yardstick only: PyTorch's is_causal is aligned top-left, as K1's mask is.
                library.append(time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), iters))
        kernel_ms = sorted(kernel)[1]
        library_ms = sorted(library)[1] if library else None
        bound_ms, bound_by, fma_bound_ms = k1_bound(b, h, t, tk, d, dtype, causal)
        row = {"shape": name, "B": b, "H": h, "T": t, "Tk": tk, "D": d, "dtype": dtype,
               "causal": causal, "max_abs_err": max(err, lse_err), "atol": atol,
               "rtol": rtol, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "kernel_ms_runs": kernel, "library_ms_runs": library}
        if dtype == "float32":
            row["fma_bound_ms"] = fma_bound_ms
        print("K1", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def by_session(events):
    out = {}
    for ev in events:
        if ev.index >= 0:
            out.setdefault(ev.session_id, {})[ev.index] = ev.token
    return {sid: [toks[i] for i in sorted(toks)] for sid, toks in out.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)

    sys.path.insert(0, REPO)
    from flink_tensorflow_tpu_torch.ops import _build
    from flink_tensorflow_tpu_torch.ops import flash_attention as fa

    # f32 products stay f32 on the card (the reference is f32 throughout).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    logs = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"build: {build_s:.2f} s for {sorted(logs) or 'cached libraries'}", flush=True)
    for source, log in logs.items():
        for entry, line in ptxas_report(log):
            print(f"  {source}: {entry}: {line}")

    k1_rows = check_k1(fa, torch)

    from flink_tensorflow_tpu_torch.serving.cell import serve, serving_cell

    mdef, tree, cfg, requests = serving_cell(SEED)
    model = mdef.to_model(tree)
    fa.flash_attention.launches = 0
    events, seconds, metrics = serve(model, cfg, requests)
    launches = fa.flash_attention.launches
    got = by_session(events)
    if set(got) != {r.session_id for r in requests}:
        fail(f"served {len(got)} of {len(requests)} sessions")
    for r in requests:
        toks = got[r.session_id]
        if len(toks) != r.max_new_tokens or not all(0 <= x < 64 for x in toks):
            fail(f"session {r.session_id}: {len(toks)} tokens, want {r.max_new_tokens}")
    prefill_batches = metrics.counter("prefill_batches").count
    warm_prefills = len(cfg.resolved_admit_buckets()) * len(cfg.resolved_prompt_buckets())
    layers = mdef.config["num_layers"]
    if launches != layers * (prefill_batches + warm_prefills):
        fail(f"K1 launches {launches} != {layers} x ({prefill_batches} prefill batches "
             f"+ {warm_prefills} warmup prefills)")

    cpu_events, cpu_seconds, _ = serve(model, cfg, requests, "cpu")
    want = by_session(cpu_events)
    for r in requests:
        a, b = got[r.session_id], want[r.session_id]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"session {r.session_id} differs from the CPU run at step {step}: "
                 f"gpu {a[step]} vs cpu {b[step]}")

    tokens = sum(len(v) for v in got.values())
    ttft = metrics.histogram("ttft_s")
    step_s = metrics.histogram("decode_step_s")
    serving_row = {
        "sessions": len(got), "tokens": tokens, "seconds": seconds,
        "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": ttft.percentile(50) * 1e3, "ttft_p95_ms": ttft.percentile(95) * 1e3,
        "decode_step_p50_ms": step_s.percentile(50) * 1e3,
        "decode_step_p95_ms": step_s.percentile(95) * 1e3,
        "decode_steps": len(step_s.values), "prefill_batches": prefill_batches,
        "warmup_prefills": warm_prefills, "k1_launches": launches,
        "cpu_seconds": cpu_seconds, "arrivals": "flood (all 96 fed back to back)",
        "card": card,
    }
    print("serving", json.dumps(serving_row), flush=True)

    serving_k1 = k1_rows[0]
    kernels = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "flink_tensorflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "flink_tensorflow_tpu/ops/flash_attention.py:245",
        "launches": launches,
        "max_abs_err": serving_k1["max_abs_err"],
        "ms": serving_k1["kernel_ms"],
        "plain_ms": serving_k1["plain_ms"],
        "bound_ms": serving_k1["bound_ms"],
        "bound_by": serving_k1["bound_by"],
        "library_ms": serving_k1["library_ms"],
    }]}
    print(json.dumps(kernels))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
