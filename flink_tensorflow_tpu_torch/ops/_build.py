"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use, into ``flink_tensorflow_tpu_torch/_build/`` (listed
in ``.gitignore``), under a name that carries a hash of the source, so an
edited source never loads a stale library.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import typing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _start(source: str) -> typing.Optional[typing.Tuple[subprocess.Popen, str, str]]:
    """Start one nvcc; None when the library is already built."""
    out = _lib_path(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(sources: typing.Optional[typing.Sequence[str]] = None) -> typing.Dict[str, str]:
    """Compile every source (default: all of ``csrc/*.cu``), one ``nvcc``
    per source, all started together.  Returns ``{source: compiler
    output}`` (ptxas register/shared-memory report) for the ones built
    now; raises with the compiler's output on the first failure."""
    if sources is None:
        sources = sorted(s for s in os.listdir(CSRC) if s.endswith(".cu"))
    started = {s: _start(s) for s in sources}
    logs: typing.Dict[str, str] = {}
    failed = []
    for source, job in started.items():
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{source} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """The built library of ``source``, building it first if needed."""
    build_all([source])
    return ctypes.CDLL(_lib_path(source))
