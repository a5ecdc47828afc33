"""Served requests: the live latent cache's bytes over the card's
bandwidth, over the decode attention's device time in the traced slice's
decode steps, %.

Per step the program records (traced runs only) ``latent_live_bytes``
(the live positions' latent and rope key, every layer, in the pool's
dtype) and ``latent_attn_device_s`` (CUDA events around each layer's
decode attention, summed).  Reading the padded pool, or reading the cache
twice, shows as a share below 100."""

from benchmark.reference.count import PEAK_BYTES_PER_S


def read(job):
    if job.kind != "serve" or job.slice is None:
        return None
    live = job.counted_values("latent_live_bytes")
    spent = job.counted_values("latent_attn_device_s")
    if not spent or len(live) != len(spent) or sum(spent) <= 0:
        return None
    return 100.0 * sum(live) / PEAK_BYTES_PER_S / sum(spent)
