"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds the cell's weights and
record pool from the seed on the card, starts the program's job, warms
it on the cell's own shapes (all of that is ``setup_s``), measures over
``--seconds`` while the load keeps running (``--trace 1`` profiles the
device over the window's last seconds), stops the load, checks what
the program produced against the plain reference (``check.py``), and
prints one JSON object as the last line of standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics and the
device trace's ``breakdown`` with ``--trace 1``.  The numbers compared
for ``correct`` end both outputs, each beside its limit.

A run without a CUDA card, or with fewer than the cell asks for, fails
without a result; so does one in which JAX or the JAX package is loaded
by the time the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T_ORIGIN = time.monotonic()

#: Top-level module names that must not be loaded (compared whole: the
#: program's own package name begins with the last one).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "flink_tensorflow_tpu")

#: Seconds the job may take to be warm.
WARM_S = 900.0


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_ORIGIN = process_age_s()


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {name.split(".", 1)[0] for name in (modules if modules is not None else sys.modules)}
    return sorted(names & set(FORBIDDEN))


def use_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def measure(cell, seed: int, seconds: float, trace: bool, device, *,
            t_origin: float = T_ORIGIN, age: float = AGE_AT_ORIGIN) -> dict:
    """One run of ``cell``: the result object, without printing it."""
    import gc
    import threading

    import torch

    from benchmark import check, jobs
    from benchmark import trace as tracing

    phases = [("imports", time.monotonic())]
    job = jobs.kind(cell.mix["job"], cell.base)(cell, seed, device, trace)
    phases.append(("weights, pool and job", time.monotonic()))
    failed = threading.Event()
    job.start()
    job.handle.executor.failure_listeners.append(failed.set)
    deadline = time.monotonic() + WARM_S
    while not job.warm():
        if failed.is_set() or time.monotonic() > deadline:
            job.stop()
            job.handle.wait(jobs.END_S)   # raises the job's failure
            raise RuntimeError("the job did not warm up")
        time.sleep(0.005)
    # What set-up made lives to the end: keep it out of the collector's
    # full passes, which would stop every thread of the job in the window.
    phases.append(("warm-up", time.monotonic()))
    gc.collect()
    gc.freeze()
    prof = None
    if trace:
        # The device's activity alone (tracing every host op as well
        # slows the lanes' launches enough to double the idle share),
        # switched on before the window, so its start-up is not in it
        # and the whole window runs under its cost alike.  Its events
        # are kept only over the slice, the window's last seconds, and
        # read once the window has closed.
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(
            activities=[act.CUDA if device.type == "cuda" else act.CPU],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1))
        prof.start()
    t0 = time.monotonic()
    job.t0, job.t1 = t0, t0 + seconds
    job.mark("t0")
    job.seconds = seconds
    job.setup_s = t0 - t_origin + age
    marks = [t_origin - age] + [t for _, t in phases]
    print("set-up phases (s): " + ", ".join(
        f"{name} {b - a!r}" for (name, _), a, b in zip(phases, marks, marks[1:])),
        file=sys.stderr)
    job.slice = None
    if trace:
        span = min(float(cell.mix["trace_slice_s"]), seconds)
        time.sleep(max(0.0, job.t1 - span - time.monotonic()))
        prof.step()     # keep events from here on
        a, a_ns = time.monotonic(), time.time_ns()
        job.mark("a")
    time.sleep(max(0.0, job.t1 - time.monotonic()))
    job.mark("t1")
    if trace:
        b, b_ns = time.monotonic(), time.time_ns()
        job.counted = ("a", "t1")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.step()     # the slice's end: its events are read here
        prof.stop()
    job.finish()
    if failed.is_set():
        raise RuntimeError("the job failed")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if trace:
        job.slice = tracing.from_profiler(prof, a_ns, b_ns)
        job.slice_records = job.in_window(a, b)
        del prof
        print(f"traced: {job.slice_records / (b - a)!r} records/s in the slice, "
              f"{job.in_window(job.t0, job.t1) / seconds!r} in the whole window",
              file=sys.stderr)
    gc.unfreeze()
    job.count = None
    if trace:   # the rooflines' and MFU's count of a record's work
        job.count = job.work_count()
        print(f"count a record: {job.count.flops!r} FLOP, {job.count.bytes!r} bytes, "
              f"least {job.count.least_s!r} s", file=sys.stderr)
    numbers, attempted, lost = job.check()
    correct, shown, readings = check.verdict(numbers, cell.limits, lost)
    for key, value in readings.items():
        print(f"reading {key}: {value!r} (not compared)", file=sys.stderr)
    per_second = [job.in_window(job.t0 + i, min(job.t0 + i + 1, job.t1))
                  for i in range(int(-(-seconds // 1)))]
    print(f"results per second of the window: {per_second}", file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(job)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": name,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(lost),
              "metrics": metrics, "device": dev}
    if trace:
        s = job.slice
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": [[n, v] for n, v in s.device_ops],
                               "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
    result["checked"] = shown
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import spec

    root = spec.root_of()
    use_cache_dirs(root)
    cell = spec.cell(args.workload, root)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # One intra-op thread: the program's host work runs on its own Python
    # threads, and the pool's spinning threads beside them made the
    # stream slower and its rate swing within a run (PERF.md).
    torch.set_num_threads(1)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    # Read after the window, so nvidia-smi's start-up is no part of set-up.
    card = power_limit()
    print(f"card: {card}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = card
    for key, item in result["checked"].items():
        print(f"checked {key}: {item['value']!r} limit {item['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
