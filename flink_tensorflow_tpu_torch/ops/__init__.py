"""Device ops of the port: flash attention (``ops.flash_attention``, K1, a
hand-written CUDA kernel with its plain PyTorch version) and the paged KV
layout ops, exported here.  The package keeps ``flash_attention`` as the
submodule's name, as its callers import it."""

from flink_tensorflow_tpu_torch.ops.paged_attention import (
    dense_to_pages,
    gather_pages,
    paged_attention_decode,
    pages_per_session,
    pages_to_dense,
    scatter_pages,
)

__all__ = [
    "dense_to_pages",
    "gather_pages",
    "paged_attention_decode",
    "pages_per_session",
    "pages_to_dense",
    "scatter_pages",
]
