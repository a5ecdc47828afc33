"""Host-side native pieces of the port: the SPSC record ring
(``native.ring.TensorRing`` over ``csrc/spsc_ring.cpp``)."""
