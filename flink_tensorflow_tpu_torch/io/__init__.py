"""Sources and sinks: record files and the two-phase-commit sink
(``files``), collection, generator and paced sources (``sources``), and
the job-to-job pipe (``remote``), as the JAX package's ``io`` exports
them."""

from flink_tensorflow_tpu_torch.io.files import (
    ExactlyOnceRecordFileSink,
    RecordFileSource,
    committed_files,
    read_committed,
    read_record_file,
    write_record_file,
)
from flink_tensorflow_tpu_torch.io.remote import RemoteSink, RemoteSource
from flink_tensorflow_tpu_torch.io.sources import (
    CollectionSource,
    GeneratorSource,
    PacedSource,
    ThrottledSource,
)

__all__ = [
    "CollectionSource",
    "ExactlyOnceRecordFileSink",
    "GeneratorSource",
    "PacedSource",
    "RecordFileSource",
    "RemoteSink",
    "RemoteSource",
    "ThrottledSource",
    "committed_files",
    "read_committed",
    "read_record_file",
    "write_record_file",
]
