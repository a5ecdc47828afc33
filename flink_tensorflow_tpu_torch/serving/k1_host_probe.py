"""K1's host cost at the serving shape, and how often the serving cell
hands K1 buffers it has seen before.

    python3 -m flink_tensorflow_tpu_torch.serving.k1_host_probe

To compare two checkouts, run it from the root of each, one process each,
in the order A, B, B, A.  Prints one JSON object:

- ``k1_ms`` and ``sdpa_ms``: K1 and ``scaled_dot_product_attention`` at
  the serving shape (B 8, H 4, T 16, D 16, f32, causal), each the median
  of five CUDA-event means over 500 back-to-back calls, taken in turns;
- for each of three runs of the serving cell in this process (the first
  also builds and warms up): its seconds, K1's calls, and the share of
  K1's tensor maps (q, k and v of each call: data pointer, shape, strides,
  dtype) and of its calls (every map) that had been seen before in the
  process.  That share is the most that a cache of encoded maps keyed by
  those arguments could hit.
"""

from __future__ import annotations

import json
import subprocess
import sys

TURNS, ITERS = 5, 500


def time_ms(torch, fn, iters: int) -> float:
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


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k1_host_probe: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from flink_tensorflow_tpu_torch.ops import flash_attention as fa
    from flink_tensorflow_tpu_torch.serving.cell import serve, serving_cell

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False

    seen = set()
    tally = {}
    launch = fa._kernel

    def recording(q, k, v, causal, return_lse):
        keys = [(x.data_ptr(), tuple(x.shape), x.stride(), x.dtype) for x in (q, k, v)]
        if k.shape[1] == 0:
            keys = keys[:1]  # no K/V map is encoded for Tk = 0
        old = [key in seen for key in keys]
        tally["calls"] += 1
        tally["calls_seen"] += all(old)
        tally["maps"] += len(keys)
        tally["maps_seen"] += sum(old)
        seen.update(keys)
        return launch(q, k, v, causal, return_lse)

    mdef, tree, cfg, requests = serving_cell(0)
    model = mdef.to_model(tree)
    fa._kernel = recording
    runs = []
    for _ in range(3):
        tally.update(calls=0, calls_seen=0, maps=0, maps_seen=0)
        _, seconds, _ = serve(model, cfg, requests)
        runs.append({"seconds": seconds, "k1_calls": tally["calls"],
                     "maps_seen_share": tally["maps_seen"] / max(tally["maps"], 1),
                     "calls_seen_share": tally["calls_seen"] / max(tally["calls"], 1),
                     "distinct_maps": len(seen)})
    fa._kernel = launch

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(8, 16, 4, 16, device="cuda", generator=gen) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kernel, library = [], []
    for _ in range(TURNS):
        kernel.append(time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), ITERS))
        library.append(time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), ITERS))
    print(json.dumps({"card": card, "k1_ms": sorted(kernel)[TURNS // 2],
                      "sdpa_ms": sorted(library)[TURNS // 2], "k1_ms_runs": kernel,
                      "sdpa_ms_runs": library, "serving_runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
