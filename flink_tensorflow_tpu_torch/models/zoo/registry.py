"""Zoo registry — names architectures so they can be rebuilt by name.

Port of ``flink_tensorflow_tpu/models/zoo/registry.py``.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """An instantiable architecture: module class + typed methods.

    ``init_fn(seed)`` returns the weights: a numpy tree in the JAX
    package's layout (so the same weights can feed both packages), or,
    for a def with ``load_fn``, whatever that function takes (the port's
    own initialised module).  ``to_model`` carries them into the module:
    through ``load_fn`` when set, else through the weight bridge
    (``models/convert.py:params_from_jax``)."""

    architecture: str
    config: typing.Dict[str, typing.Any]
    module: typing.Any  # torch.nn.Module subclass
    input_schema: RecordSchema
    methods: typing.Mapping[str, ModelMethod]
    init_fn: typing.Callable[[typing.Any], typing.Any]
    #: ``params -> nn.Module``; None loads ``module(**config)`` from a
    #: numpy tree through ``params_from_jax``.
    load_fn: typing.Optional[typing.Callable[[typing.Any], typing.Any]] = None
    #: ``loss_fn(module, batch, generator) -> (loss, (new_model_state,
    #: metrics))`` for trainable defs (JAX ``loss_fn(variables, batch,
    #: rng)``): ``module`` runs on the train state's tensors (the train step
    #: calls it through ``torch.func.functional_call``), ``batch`` is a dict
    #: of device tensors with the ``valid`` mask, ``new_model_state`` holds
    #: the non-trained collections (``{"batch_stats": {name: tensor}}``).
    #: None for inference-only defs.
    loss_fn: typing.Optional[typing.Callable] = None
    #: ``() -> nn.Module`` of this def's architecture with placeholder
    #: weights; under ``torch.device("meta")`` it is the storage-free
    #: skeleton a train step runs ``functional_call`` on.
    make_module: typing.Optional[typing.Callable[[], typing.Any]] = None

    def init_params(self, seed) -> typing.Any:
        return self.init_fn(seed)

    def build_module(self, np_tree):
        if self.load_fn is not None:
            return self.load_fn(np_tree).eval()
        from flink_tensorflow_tpu_torch.models.convert import params_from_jax

        module = self.module(**self.config)
        module.load_state_dict(params_from_jax(np_tree))
        return module.eval()

    def to_model(self, np_tree, name: typing.Optional[str] = None) -> Model:
        return Model(
            name or self.architecture,
            self.build_module(np_tree),
            self.methods,
            metadata={"architecture": self.architecture, "config": dict(self.config)},
        )


_BUILDERS: typing.Dict[str, typing.Callable[..., ModelDef]] = {}


def register_model_def(name: str):
    def deco(builder):
        _BUILDERS[name] = builder
        return builder

    return deco


_ZOO_MODULES = ("chartransformer", "inception", "widedeep", "resnet", "lenet", "bilstm")


def get_model_def(architecture: str, **config) -> ModelDef:
    # Import zoo modules lazily so registry import stays cheap.
    import importlib

    if architecture not in _BUILDERS:
        for mod in _ZOO_MODULES:
            importlib.import_module(f"flink_tensorflow_tpu_torch.models.zoo.{mod}")
    try:
        builder = _BUILDERS[architecture]
    except KeyError:
        raise KeyError(
            f"unknown architecture {architecture!r}; registered: {sorted(_BUILDERS)}"
        ) from None
    return builder(**config)
