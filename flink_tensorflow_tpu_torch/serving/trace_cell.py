"""Where the serving cell's time goes on the card.

    python3 -m flink_tensorflow_tpu_torch.serving.trace_cell [--keyed]

Runs the serving cell (``serving/cell.py``) three times on the GPU,
through the one-subtask loop (``serve``) or, with ``--keyed``, through the
keyed pipeline on the local executor (``serve_keyed``): once
to warm up (kernel build, allocator, library handles), once untraced for
the end-to-end time, and once under ``torch.profiler`` for the device
side.  Prints one JSON object: end-to-end seconds untraced and traced,
device kernel time and the device's busy share of the traced wall time,
launches and device time per kernel name (top 10), K1's launches, device
time and share of device time, and the host split between prefill calls,
decode-step calls and the rest of the operator.
"""

from __future__ import annotations

import json
import subprocess
import sys

#: Name of K1's kernel (``csrc/flash_attention.cu``) in the profiler's table.
K1_KERNEL = "flash_fwd_kernel"


def main(argv=None) -> int:
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_cell: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from flink_tensorflow_tpu_torch.serving.cell import serve, serve_keyed, serving_cell

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--keyed", action="store_true",
                        help="drive the keyed pipeline instead of one subtask loop")
    args = parser.parse_args(argv)
    run = serve_keyed if args.keyed else serve
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    mdef, tree, cfg, requests = serving_cell(0)
    model = mdef.to_model(tree)
    run(model, cfg, requests)
    _, seconds, metrics = run(model, cfg, requests)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced_seconds, _ = run(model, cfg, requests)

    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            kernels.append({"name": evt.key[:90], "launches": evt.count, "device_ms": us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    device_ms = sum(k["device_ms"] for k in kernels)
    k1 = [k for k in kernels if K1_KERNEL in k["name"]]
    k1_ms = sum(k["device_ms"] for k in k1)
    prefill_s = sum(metrics.histogram("prefill_s").values)
    decode_s = sum(metrics.histogram("decode_step_s").values)
    out = {
        "card": card,
        "entry": "serve_keyed" if args.keyed else "serve",
        "untraced_s": seconds,
        "traced_s": traced_seconds,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / 1e3 / traced_seconds,
        "kernel_launches": sum(k["launches"] for k in kernels),
        "host_prefill_s": prefill_s,
        "host_decode_step_s": decode_s,
        "host_other_s": seconds - prefill_s - decode_s,
        "prefill_calls": len(metrics.histogram("prefill_s").values),
        "decode_steps": len(metrics.histogram("decode_step_s").values),
        "k1_launches": sum(k["launches"] for k in k1),
        "k1_device_ms": k1_ms,
        "k1_share_of_device": k1_ms / device_ms if device_ms else 0.0,
        "top_kernels": kernels[:10],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
