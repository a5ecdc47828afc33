"""The model zoo of the port: one ``torch.nn.Module`` per architecture of
the JAX package's zoo (``chartransformer``, ``inception``, ``lenet``,
``resnet``, ``bilstm``, ``widedeep``), each registered by name with its
typed methods and, where it trains, its ``loss_fn``."""

from flink_tensorflow_tpu_torch.models.zoo.registry import (
    ModelDef,
    get_model_def,
    register_model_def,
)

__all__ = ["ModelDef", "get_model_def", "register_model_def"]
