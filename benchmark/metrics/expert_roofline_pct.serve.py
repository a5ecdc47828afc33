"""Served requests: the routed experts' least time over the expert
layers' device time in the traced slice's decode steps, %.

Per step the program records (traced runs only) ``moe_routed_rows`` (live
rows x experts per token x expert layers), ``moe_experts_touched``
(experts with a row, summed over the layers) and ``moe_device_s`` (CUDA
events around each expert layer, summed).  The routed work of a step is
``rows x 3 x 2 x D x F`` FLOPs (gate, up, down) and the touched experts'
weights, ``touched x 3 x D x F x 2`` bytes (bf16); its least time is the
larger of the two over the card's peaks.  The layer's time also holds the
router, the sort, the weighting and the shared experts, so this reads
below the grouped matmuls' own share."""

from benchmark.reference.count import PEAK_BYTES_PER_S, PEAK_FLOPS


def read(job):
    if job.kind != "serve" or job.slice is None:
        return None
    rows = job.counted_values("moe_routed_rows")
    touched = job.counted_values("moe_experts_touched")
    spent = job.counted_values("moe_device_s")
    if not spent or len(rows) != len(spent) or len(touched) != len(spent) or sum(spent) <= 0:
        return None
    port = job.config["port"]
    matrix = port["hidden_size"] * port["moe_intermediate_size"]
    least = sum(max(r * 6 * matrix / PEAK_FLOPS, t * 3 * matrix * 2 / PEAK_BYTES_PER_S)
                for r, t in zip(rows, touched))
    return 100.0 * least / sum(spent)
