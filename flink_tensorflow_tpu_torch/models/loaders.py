"""Model bundles: ``save_bundle`` / ``SavedModelLoader``.

Port of ``flink_tensorflow_tpu/models/loaders.py`` (``:40-115``), as a
torch-native bundle.  A bundle is a directory holding

- ``model.json``: ``{"format": "flink-tensorflow-tpu-torch-bundle",
  "version": 1, "architecture": ..., "config": {...}}``, the
  architecture and config the zoo registry rebuilds the module from;
- ``params.pt``: the module's ``state_dict`` (host tensors), read back
  with ``torch.load(weights_only=True, map_location="cpu")``.

A bundle stays on the host until an operator's ``open()`` places it on
its device; ``ModelMapFunction(path)`` loads it once per subtask.  The
JAX package's bundles (``flink-tensorflow-tpu-bundle``, flax msgpack) are
refused: their weights reach the port as numpy through the bridge in
``models/convert.py``.

Frozen graphs (JAX ``:116-177``), the reference's ``GraphDef``
analogue: :func:`freeze_method` exports one model method with
``torch.export``, its weights baked in as constants, specialised to one
batch (and, for a ``needs_lengths`` method, one length bucket) as the
JAX export is, and returns the bytes of ``torch.export.save``.
:meth:`GraphLoader.load` turns those bytes (or a file of them) into the
callable ``torch.export.load(...).module()`` gives: weights inside, no
model class of the port needed.

Devices: an exported program bakes in the device it was traced on (its
constants, and any device argument of its ops).  ``freeze_method``
traces on the device it is given (the card by default); ``load`` returns
the program on that device unless asked for another, which it then
moves explicitly (``torch.export.passes.move_to_device_pass``).  The
Graph functions (``functions/model_function.py``) load it onto their
subtask's device at ``open()``.  Tracing runs no kernel, so it makes no
cuDNN choice: the runner that calls the program holds cuDNN to its
heuristics, as for any model.
"""

from __future__ import annotations

import copy
import io
import json
import os
import shutil
import typing

import torch

from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, get_model_def
from flink_tensorflow_tpu_torch.tensors.transfer import torch_dtype
from flink_tensorflow_tpu_torch.utils.device import resolve_device

BUNDLE_MANIFEST = "model.json"
BUNDLE_PARAMS = "params.pt"
BUNDLE_FORMAT = "flink-tensorflow-tpu-torch-bundle"
#: The JAX package's bundle format, refused with a pointer to the bridge.
JAX_BUNDLE_FORMAT = "flink-tensorflow-tpu-bundle"


def save_bundle(model_def: ModelDef, module: torch.nn.Module, path: str) -> None:
    """Write ``module``'s weights and ``model_def``'s architecture and
    config as a bundle at ``path``.

    Staged write and atomic rename: a crash mid-export never leaves a
    directory that parses as a bundle but holds truncated params."""
    tmp = path.rstrip("/") + ".exporting"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "format": BUNDLE_FORMAT,
        "version": 1,
        "architecture": model_def.architecture,
        "config": model_def.config,
    }
    with open(os.path.join(tmp, BUNDLE_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    state = {k: v.detach().to("cpu") for k, v in module.state_dict().items()}
    with open(os.path.join(tmp, BUNDLE_PARAMS), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


class SavedModelLoader:
    """Loads a bundle directory into a host-side :class:`Model`: the
    module is rebuilt from the registry and its weights restored."""

    def __init__(self, path: str):
        self.path = path

    def manifest(self) -> dict:
        with open(os.path.join(self.path, BUNDLE_MANIFEST)) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt == JAX_BUNDLE_FORMAT:
            raise ValueError(
                f"{self.path} is a JAX package bundle (flax msgpack); the port does not "
                "read flax: carry its params as numpy through "
                "flink_tensorflow_tpu_torch.models.convert (e.g. lenet_from_flax) and "
                "save_bundle the result")
        if fmt != BUNDLE_FORMAT:
            raise ValueError(f"{self.path} is not a {BUNDLE_FORMAT} bundle (format {fmt!r})")
        return manifest

    def load(self) -> Model:
        manifest = self.manifest()
        model_def = get_model_def(manifest["architecture"], **manifest["config"])
        module = (model_def.make_module() if model_def.make_module is not None
                  else model_def.module(**model_def.config))
        state = torch.load(os.path.join(self.path, BUNDLE_PARAMS), weights_only=True,
                           map_location="cpu")
        module.load_state_dict(state)
        return Model(model_def.architecture, module.eval(), model_def.methods,
                     metadata={"architecture": model_def.architecture,
                               "config": dict(model_def.config)})


# ---------------------------------------------------------------------------
# Frozen graphs (GraphDef analogue)
# ---------------------------------------------------------------------------

def _constants(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with every parameter and buffer turned into a plain
    tensor attribute, which ``torch.export`` bakes in as a constant."""
    for m in module.modules():
        for table in (m._parameters, m._buffers):
            for name, t in list(table.items()):
                del table[name]
                if t is not None:
                    object.__setattr__(m, name, t.detach())
    return module


class _Frozen(torch.nn.Module):
    """The method as a module: ``forward(inputs[, lengths])``."""

    def __init__(self, module: torch.nn.Module, fn, needs_lengths: bool):
        super().__init__()
        self.module = module
        self.fn = fn
        self.needs_lengths = needs_lengths

    def forward(self, inputs, lengths=None):
        if self.needs_lengths:
            return self.fn(self.module, inputs, lengths)
        return self.fn(self.module, inputs)


def freeze_method(model: Model, method_name: str = "serve", *, batch: int = 1,
                  length_bucket: int = 128, device=None) -> bytes:
    """Export one model method with its weights baked in -> the bytes of
    ``torch.export.save``.  The program is specialised to ``batch`` rows
    and, for a ``needs_lengths`` method, to ``length_bucket`` along every
    dynamic dim (with ``[batch]`` int32 lengths per dynamic field), as a
    frozen GraphDef is to its placeholder shapes.  Traced on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    method = model.method(method_name)
    schema = method.input_schema
    shapes = schema.resolve_dynamic(length_bucket)
    module = _constants(copy.deepcopy(model.params).to(dev).eval())
    example = {n: torch.zeros((batch, *shapes[n]), dtype=torch_dtype(schema[n].dtype),
                              device=dev) for n in schema.names}
    args: typing.Tuple = (example,)
    if method.needs_lengths:
        args += ({n: torch.full((batch,), length_bucket, dtype=torch.int32, device=dev)
                  for n in schema.names if not schema[n].is_static},)
    with torch.no_grad():
        exported = torch.export.export(_Frozen(module, method.fn, method.needs_lengths), args)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


class GraphLoader:
    """Loads a frozen graph (``freeze_method``'s bytes, or a file of them)
    into a callable: ``fn(inputs)`` or ``fn(inputs, lengths)`` over dicts
    of ``[batch, ...]`` tensors, returning the method's dict of outputs.
    A call at another batch or length than the frozen one is refused."""

    def __init__(self, source: typing.Union[str, bytes]):
        self.source = source

    def load(self, device=None) -> typing.Callable:
        """The program on the device it was frozen on, or moved to
        ``device`` when given."""
        data = self.source
        if isinstance(data, str):
            with open(data, "rb") as f:
                data = f.read()
        exported = torch.export.load(io.BytesIO(data))
        if device is not None:
            from torch.export.passes import move_to_device_pass

            exported = move_to_device_pass(exported, resolve_device(device))
        return exported.module()
