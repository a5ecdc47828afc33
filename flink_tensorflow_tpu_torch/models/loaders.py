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
``models/convert.py``.  ``GraphLoader`` and ``freeze_method`` are not
ported yet.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, get_model_def

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
