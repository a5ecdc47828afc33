"""Plain PyTorch references of the benchmark's configurations.

Each module here is written from its paper, in float32 with no kernel,
cache or batching of the program under test, and imports nothing of it:
the benchmark holds what the program produces against these.  ``arith``
holds the arithmetic every layer goes through (exact float32, or the
lower-precision control); ``count`` counts a configuration's operations
and bytes from these modules on meta tensors.
"""

from __future__ import annotations

import importlib
import types


def module_for(name: str) -> types.ModuleType:
    """The reference module a configuration file names (``"reference"``)."""
    return importlib.import_module(f"benchmark.reference.{name}")
