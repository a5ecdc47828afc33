"""Build and load the port's native code.

Each ``csrc/*.cu`` source (a CUDA kernel) compiles with ``nvcc`` for
``sm_90a``, and each ``csrc/*.cpp`` source (host code: the ring's SPSC
counters) with the host C++ compiler (``$CXX``, else ``c++``), into a
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use, into ``flink_tensorflow_tpu_torch/_build/`` (listed
in ``.gitignore``), under a name that carries a hash of the source, so an
edited source never loads a stale library.  A failed build raises; there
is no fallback.  Nothing here runs at import.
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
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "c++")
    if found:
        return found
    raise RuntimeError("no host C++ compiler ($CXX or c++) to build the port's "
                       "native ring")


def _compiler(source: str) -> typing.List[str]:
    if source.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS]
    return [_cxx(), *CXX_FLAGS]


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _start(source: str) -> typing.Optional[typing.Tuple[subprocess.Popen, str, str]]:
    """Start one compiler; None when the library is already built."""
    out = _lib_path(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.Popen(
            [*_compiler(source), "-o", tmp, os.path.join(CSRC, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except BaseException:
        os.unlink(tmp)
        raise
    return proc, tmp, out


def build_all(sources: typing.Optional[typing.Sequence[str]] = None) -> typing.Dict[str, str]:
    """Compile every source (default: all of ``csrc/*.cu`` and
    ``csrc/*.cpp``), one compiler per source, all started together.
    Returns ``{source: compiler output}`` (for a kernel, ptxas's
    register/shared-memory report) for the ones built now; raises with
    the compiler's output on the first failure."""
    if sources is None:
        sources = sorted(s for s in os.listdir(CSRC) if s.endswith((".cu", ".cpp")))
    started: typing.Dict[str, typing.Any] = {}
    try:
        for source in sources:
            started[source] = _start(source)
    except BaseException:
        for job in started.values():
            if job is not None:
                job[0].kill()
                job[0].wait()
                os.unlink(job[1])
        raise
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
        raise RuntimeError("build failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(source: str, hold_gil: bool = False) -> ctypes.CDLL:
    """The built library of ``source``, building it first if needed.
    ``hold_gil`` loads it as a ``ctypes.PyDLL``: its calls keep the
    interpreter lock (for calls shorter than the lock's hand-over)."""
    build_all([source])
    return (ctypes.PyDLL if hold_gil else ctypes.CDLL)(_lib_path(source))
