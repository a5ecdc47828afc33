"""``python -m flink_tensorflow_tpu_torch.tracing`` — the span tracer CLI."""

from flink_tensorflow_tpu_torch.tracing.cli import cli

if __name__ == "__main__":
    cli()
