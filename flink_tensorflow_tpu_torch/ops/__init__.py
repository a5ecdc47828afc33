"""Device ops of the port: flash attention (``ops.flash_attention``, K1, a
hand-written CUDA kernel with its plain PyTorch version), the paged KV
layout ops and the image preprocessing ops, exported here, and the conv
nets' train-mode batch norm (``ops.batch_norm``, a hand-written CUDA
kernel pair with its plain version).  The package
keeps ``flash_attention`` as the submodule's name, as its callers import
it (``ops.flash_attention.flash_attention`` is the function the
reference exports as ``ops.flash_attention``)."""

from flink_tensorflow_tpu_torch.ops.flash_attention import flash_attention_decode
from flink_tensorflow_tpu_torch.ops.paged_attention import (
    dense_to_pages,
    gather_pages,
    paged_attention_decode,
    pages_per_session,
    pages_to_dense,
    scatter_pages,
)
from flink_tensorflow_tpu_torch.ops.preprocessing import (
    central_crop,
    inception_normalize,
    mnist_normalize,
    normalize_image,
    resize_bilinear,
)

__all__ = [
    "flash_attention_decode",
    "dense_to_pages",
    "gather_pages",
    "paged_attention_decode",
    "pages_per_session",
    "pages_to_dense",
    "scatter_pages",
    "central_crop",
    "inception_normalize",
    "mnist_normalize",
    "normalize_image",
    "resize_bilinear",
]
