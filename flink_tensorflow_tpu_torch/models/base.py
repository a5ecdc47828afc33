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
