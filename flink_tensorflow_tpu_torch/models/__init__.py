"""Models of the port: typed methods over ``torch.nn.Module`` params
(``base``), bundles and frozen graphs (``loaders``) and the zoo, with the
names ``flink_tensorflow_tpu/models/__init__.py`` exports but its
TensorFlow loaders (``models/tf_loader.py`` needs TensorFlow's bridge to
jax; the port reads TF weights through ``models/import_tf.py``)."""

from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod
from flink_tensorflow_tpu_torch.models.loaders import (
    GraphLoader,
    SavedModelLoader,
    freeze_method,
    save_bundle,
)
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, get_model_def

__all__ = [
    "GraphLoader",
    "Model",
    "ModelDef",
    "ModelMethod",
    "SavedModelLoader",
    "freeze_method",
    "get_model_def",
    "save_bundle",
]
