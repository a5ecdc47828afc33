"""Host-side native pieces of the port: the SPSC record ring
(``native.ring.TensorRing`` over ``csrc/spsc_ring.cpp``)."""

from flink_tensorflow_tpu_torch.native.ring import TensorRing, native_available

__all__ = ["TensorRing", "native_available"]
