"""Where the Inception streaming cell's time goes on the card.

    python3 -m flink_tensorflow_tpu_torch.models.inception_trace

Runs the cell (``models/inception_cell.py``) three times on the GPU: once
to warm up (cuDNN's algorithm search, allocator, pinned buffers), once
untraced for the end-to-end numbers, and once under ``torch.profiler``
for the device side.  Prints one JSON object:

- end-to-end: job seconds untraced and traced, steady records/s
  (``bench.py:_steady_rps``'s cut) and records over the whole job's
  seconds, of the untraced run;
- the device: kernel time, busy share (kernel time, which runs on the
  one compute stream) of the traced job's wall time and of the span from
  the first to the last device event, launches per
  batch (kernels, and memcpy/memset separately), the top kernels by
  device time, and the device time of the H2D and D2H copies;
- the host, summed over the untraced run's batches: assemble, H2D
  enqueue (staging wait + copy issue), dispatch (H2D enqueue + kernel
  launches) and the fetch thread's wait on each batch's event (compute
  wait + D2H) — these overlap across the two lane threads and the fetch
  thread — and the top host-side ops of the trace by self CPU time;
- the module's forward alone at batch 128 (CUDA events, main thread),
  with cuDNN's heuristic algorithm choice (what the runner uses) and
  with its timed search (``torch.backends.cudnn.benchmark``).
"""

from __future__ import annotations

import json
import subprocess
import sys


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("inception_trace: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from flink_tensorflow_tpu_torch.models import inception_cell as cell
    from flink_tensorflow_tpu_torch.models.stream_cell import steady_rps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _, model, _, records = cell.inception_cell(0)
    cell.run_cell(model, records)
    _, arrivals, metrics, seconds = cell.run_cell(model, records)
    # cuDNN's choices are cached in the process: the traced run needs no
    # warmup batch, so the trace holds the 16 live batches only.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, traced_metrics, traced_seconds = cell.run_cell(model, records, warmup=False)
    torch.cuda.synchronize()

    batches = traced_metrics["inception.0.batches"]
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
    copy_ms = sum(c["device_ms"] for c in copies)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > 0]
    active_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3 if spans else 0.0

    def host_sum(name: str) -> float:
        """Seconds summed over the untraced run's batches (count x mean)."""
        h = metrics[f"inception.0.{name}"]
        return float(h["count"] * h["mean"])

    rps, span = steady_rps(arrivals, cell.RECORDS, cell.BATCH,
                           cell.trailing_exclude(cell.RECORDS))
    out = {
        "card": card,
        "untraced_s": seconds,
        "traced_s": traced_seconds,
        "records_per_s": rps,
        "steady_span_s": span,
        "job_records_per_s": cell.RECORDS / seconds,
        "batches": batches,
        "device_kernel_ms": kernel_ms,
        "device_copy_ms": copy_ms,
        # Kernels run on the one compute stream (copies on the side
        # stream overlap them), so kernel time is the compute busy time.
        "device_busy_share_of_job": kernel_ms / 1e3 / traced_seconds,
        "device_active_span_ms": active_ms,
        "device_busy_share_of_active_span": kernel_ms / active_ms if active_ms else 0.0,
        "kernel_launches_per_batch": sum(k["launches"] for k in kernels) / batches,
        "copy_launches_per_batch": sum(c["launches"] for c in copies) / batches,
        "copies": copies,
        "top_kernels": kernels[:12],
        "host_assemble_s": host_sum("assemble_s"),
        "host_h2d_enqueue_s": host_sum("h2d_s"),
        "host_dispatch_s": host_sum("dispatch_s"),
        "host_fetch_wait_s": host_sum("fetch_wait_s"),
    }
    host_ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)[:10]
    out["top_host_ops"] = [{"name": e.key[:60], "calls": e.count,
                            "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in host_ops]
    out["forward_ms"] = forward_ms(torch, model)
    print(json.dumps(out))
    return 0


def forward_ms(torch, model) -> dict:
    """The bf16 forward at batch 128 on the main thread, heuristic and
    timed cuDNN algorithm choice, each the median of 3 CUDA-event means
    over 10 calls."""
    import copy

    from flink_tensorflow_tpu_torch.models import inception_cell as cell

    module = copy.deepcopy(model.params).to("cuda").eval()
    serve = model.method("serve").fn
    x = torch.randint(0, 256, (cell.BATCH, cell.IMAGE, cell.IMAGE, 3), dtype=torch.uint8,
                      device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    out = {}
    for name, benchmark in (("heuristic", False), ("benchmark", True)):
        torch.backends.cudnn.benchmark = benchmark
        runs = []
        with torch.inference_mode():
            for _ in range(3):
                for _ in range(3):
                    serve(module, {"image": x})
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    serve(module, {"image": x})
                end.record()
                end.synchronize()
                runs.append(start.elapsed_time(end) / 10)
        out[name] = sorted(runs)[1]
    torch.backends.cudnn.benchmark = False
    return out


if __name__ == "__main__":
    sys.exit(main())
