"""Model abstraction — typed model methods.

Port of ``flink_tensorflow_tpu/models/base.py``.  In the port a model's
``params`` is its ``torch.nn.Module`` (held on the host until a runner
copies it to its device), and a method is ``fn(module, inputs) ->
outputs`` over dicts of tensors.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema

Params = typing.Any  # torch.nn.Module
ApplyFn = typing.Callable[..., typing.Dict[str, typing.Any]]


@dataclasses.dataclass(frozen=True)
class ModelMethod:
    """One named, typed entry point of a model.

    ``fn(module, inputs)`` takes the batched inputs (field -> ``[B, ...]``
    tensor) and returns a dict of named ``[B, ...]`` outputs.  A method
    with ``needs_lengths`` is called ``fn(module, inputs, lengths)``:
    ``lengths`` maps each field with a dynamic dim to its ``[B]`` int32
    true lengths, on the inputs' device (JAX ``models/base.py:32-40``)."""

    name: str
    input_schema: RecordSchema
    output_names: typing.Tuple[str, ...]
    fn: ApplyFn
    needs_lengths: bool = False


class KVCacheSpec(typing.NamedTuple):
    """What a served model's cache holds (its module's
    ``kv_cache_spec()``): ``layers`` layers of two parts a token, each
    ``(heads, width)``, in ``dtype``.  The serving runners shape their
    pools and blocks from it: ``char_transformer``'s K and V are
    ``(H, Dh)`` each, DeepSeek-V2's latent ``(1, 512)`` and ``(1, 64)``."""

    layers: int
    parts: typing.Tuple[typing.Tuple[int, int], typing.Tuple[int, int]]
    dtype: typing.Any


class Model:
    """A loaded model: params + named methods."""

    def __init__(
        self,
        name: str,
        params: Params,
        methods: typing.Mapping[str, ModelMethod],
        metadata: typing.Optional[dict] = None,
    ):
        self.name = name
        self.params = params
        self._methods = dict(methods)
        self.metadata = dict(metadata or {})

    def method(self, name: str = "serve") -> ModelMethod:
        try:
            return self._methods[name]
        except KeyError:
            raise KeyError(
                f"model {self.name!r} has no method {name!r}; available: {sorted(self._methods)}"
            ) from None

    @property
    def methods(self) -> typing.Mapping[str, ModelMethod]:
        return self._methods

    def with_params(self, params: Params) -> "Model":
        """A new model over ``params`` (an ``nn.Module``) with this one's
        name, methods and metadata; this model is left as it was."""
        return Model(self.name, params, self._methods, self.metadata)


def meta_module(module):
    """A copy of ``module`` whose parameters and buffers are meta tensors
    of the same shapes and dtypes: what the plan-time passes run a method
    on (shapes propagate, nothing is allocated on any device, and the
    weights are not copied)."""
    import copy

    import torch

    memo = {}
    for p in module.parameters():
        memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                         requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(module, memo)


def numpy_dtype(dtype) -> "typing.Any":
    """The numpy dtype of a torch dtype (raises for one numpy lacks, as
    bfloat16)."""
    import numpy as np

    return np.dtype(str(dtype).replace("torch.", ""))
