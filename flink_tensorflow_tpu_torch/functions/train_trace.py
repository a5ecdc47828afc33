"""Where the training cells' time goes on the card.

    python3 -m flink_tensorflow_tpu_torch.functions.train_trace

Runs each training cell (``functions/train_cell.py``) three times on the
GPU: once to warm up (cuDNN's plans, the allocator), once untraced for the
end-to-end numbers and once under ``torch.profiler`` for the device side.
Prints one JSON object per cell:

- end-to-end: job seconds untraced and traced, records/s over the steps
  after the first, steps;
- the device: kernel time, busy share (kernel time of the one compute
  stream) of the traced job's wall time and of the span from the first to
  the last device event, kernel and copy launches per step, the top
  kernels by device time;
- the host: seconds per step of the traced job's wall time, and (the
  gang) the subtask's host seconds to assemble, ship and launch a step.

``profile(run, steps)`` is what ``chip_smoke.py`` phase 7 calls.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import typing


def profile(torch, run: typing.Callable[[], typing.Any], steps: int) -> dict:
    """Run ``run()`` (one job) under ``torch.profiler`` and summarise the
    device side per training step."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    kernels, copies = [], []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us <= 0:
            continue
        row = {"name": evt.key[:90], "launches": evt.count, "device_ms": us / 1e3}
        (copies if evt.key.startswith(("Memcpy", "Memset")) else kernels).append(row)
    kernels.sort(key=lambda k: -k["device_ms"])
    kernel_ms = sum(k["device_ms"] for k in kernels)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > 0]
    active_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3 if spans else 0.0
    return {
        "traced_s": seconds,
        "device_kernel_ms": kernel_ms,
        "device_copy_ms": sum(c["device_ms"] for c in copies),
        "device_busy_share_of_job": kernel_ms / 1e3 / seconds,
        "device_active_span_ms": active_ms,
        "device_busy_share_of_active_span": kernel_ms / active_ms if active_ms else 0.0,
        "kernel_launches_per_step": sum(k["launches"] for k in kernels) / steps,
        "copy_launches_per_step": sum(c["launches"] for c in copies) / steps,
        "host_s_per_step_traced": seconds / steps,
        "top_kernels": kernels[:10],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_trace: CUDA is not available; this script runs on the GPU", file=sys.stderr)
        return 2
    from flink_tensorflow_tpu_torch.functions import train_cell as cell
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    mdef, schema, records = cell.resnet_cell()
    mesh = make_mesh({"data": 1})
    cell.run_resnet(mdef, schema, records, mesh)
    run = cell.run_resnet(mdef, schema, records, mesh)
    steps = len(run.results)
    dispatch = run.env.metric_registry.group("dp_train.0").histogram("step_dispatch_s")
    out = {"cell": "resnet-train", "card": card, "untraced_s": run.seconds, "steps": steps,
           "records_per_s": cell.rate(run.arrivals, cell.RESNET_BATCH),
           "host_dispatch_p50_ms": dispatch.percentile(50) * 1e3,
           **profile(torch, lambda: cell.run_resnet(mdef, schema, records, mesh), steps)}
    print(json.dumps(out), flush=True)

    mdef, schema, records = cell.widedeep_cell()
    cell.run_widedeep(mdef, schema, records)
    run = cell.run_widedeep(mdef, schema, records)
    steps = len(run.results)
    out = {"cell": "widedeep-online", "card": card, "untraced_s": run.seconds, "steps": steps,
           "steps_per_s": cell.rate(run.arrivals), "records_per_s": len(records) / run.seconds,
           **profile(torch, lambda: cell.run_widedeep(mdef, schema, records), steps)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
