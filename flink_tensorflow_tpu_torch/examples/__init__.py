"""The job scripts of the port: the JAX package's ``examples/`` jobs run on
the port, one module each, run as ``python -m
flink_tensorflow_tpu_torch.examples.<name>`` (``--cpu`` runs a job on the
host; the default is the card)."""
