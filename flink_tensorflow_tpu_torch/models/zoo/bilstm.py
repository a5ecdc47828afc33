"""BiLSTM text classifier — streaming inference on variable-length records.

Port of ``flink_tensorflow_tpu/models/zoo/bilstm.py`` (``:26-103``):
embedding -> a forward and a reverse LSTM -> the two final hidden states
concatenated -> Dense(hidden) -> ReLU -> f32 Dense(classes).  The stream
layer pads each batch to a length bucket, and the true lengths arrive as
a ``[B]`` int32 tensor (``ModelMethod.needs_lengths``): they drive which
steps count, never the shapes.

What is held equal to flax (``nn.RNN(OptimizedLSTMCell)`` with
``seq_lengths``, ``return_carry=True``; the reverse one with
``reverse=True, keep_order=True``):

- the forward pass runs over the padded row and its hidden state is taken
  at step ``length - 1``; the reverse pass runs over the row with its
  valid prefix reversed (flax ``flip_sequences``: step t reads token
  ``(T - 1 - t + length) % T``), and its state is taken at ``length - 1``
  too, so it has seen exactly the valid prefix;
- a record of length 0 takes the state at step ``T - 1`` in both
  directions, as flax's ``x[length - 1]`` wraps to the last step: the
  answer of such a record depends on its batch's bucket, in both packages;
- the embedding table is stored in ``compute_dtype`` (flax
  ``param_dtype=bf16``); the LSTM kernels and biases are f32 parameters;
- each cell (``OptimizedLSTMCell(dtype=bf16)``) rounds ``x``, ``h``, its
  kernels and its bias to bf16, takes both products in bf16, adds them in
  bf16 and applies the gates in bf16; ``c`` and ``h`` stay f32 (the carry
  starts as f32 zeros and ``f * c`` promotes);
- the hidden Dense runs in ``compute_dtype``, the head in f32.

Parameter names (``state_dict``): ``embed.weight``; ``fwd`` and ``bwd``
(``nn.LSTM`` containers: ``weight_ih_l0`` ``[4H, E]``, ``weight_hh_l0``
``[4H, H]``, ``bias_ih_l0`` zero, ``bias_hh_l0``, gate order i, f, g, o as
flax's ``ii, if, ig, io`` / ``hi, hf, hg, ho``); ``hidden``, ``head``.
Flax ``Embed_0``, ``OptimizedLSTMCell_0`` (forward), ``OptimizedLSTMCell_1``
(reverse), ``Dense_0``, ``Dense_1``.

The recurrence has three routes (``LSTM_ROUTES``):

- ``"plain"``: a Python loop over the steps that follows flax's dtypes step
  by step; the route on the CPU, and the reference the card is held to;
- ``"cudnn_f32"``: ``torch.lstm`` (cuDNN on the card) in f32 on the
  kernels and bias rounded to ``compute_dtype``, one call per direction
  over the padded batch, with TF32 off for the call; the route on the
  card (``CUDA_ROUTE``: of the two cuDNN routes the closer to the plain
  loop on the H100 at about the same time, ``PERF.md``);
- ``"cudnn_bf16"``: the same in bf16 (cuDNN keeps ``c`` in bf16 too).

Outside autograd the fused routes take their weights rounded, cast and
flattened into one cuDNN buffer once per direction, kept until a
parameter moves or changes (``_FusedWeights``).
"""

from __future__ import annotations

import contextlib
import threading
import typing

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flink_tensorflow_tpu_torch.models.base import ModelMethod
from flink_tensorflow_tpu_torch.models.zoo._common import lecun_normal_, weighted_metrics
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, register_model_def
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, TensorSpec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LSTM_ROUTES = ("plain", "cudnn_f32", "cudnn_bf16")
#: The route a module on the card takes.
CUDA_ROUTE = "cudnn_f32"
_RUN_DTYPES = {"cudnn_f32": torch.float32, "cudnn_bf16": torch.bfloat16}

_fused_lock = threading.Lock()


def _cell_params(cell: nn.LSTM) -> typing.List[torch.Tensor]:
    return [cell.weight_ih_l0, cell.weight_hh_l0, cell.bias_ih_l0, cell.bias_hh_l0]


def lstm_plain(x: torch.Tensor, cell: nn.LSTM, dtype: torch.dtype) -> torch.Tensor:
    """Every step's ``h`` (``[B, T, H]`` f32) of one direction over ``x``
    (``[B, T, E]``), following ``OptimizedLSTMCell(dtype=dtype)``."""
    w_ih, w_hh, b_ih, b_hh = (p.to(dtype) for p in _cell_params(cell))
    xp = F.linear(x.to(dtype), w_ih) + b_ih             # flax: dense_i, no bias (b_ih = 0)
    batch, steps = x.shape[:2]
    h = x.new_zeros((batch, w_hh.shape[1]), dtype=torch.float32)
    c = torch.zeros_like(h)
    out = []
    for t in range(steps):
        z = (F.linear(h.to(dtype), w_hh) + b_hh) + xp[:, t]   # dense_h + dense_i
        i, f, g, o = z.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f.float() * c + (i * g).float()
        h = o.float() * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


@contextlib.contextmanager
def _full_f32_rnn(device: torch.device):
    """cuDNN's f32 RNN without TF32 for the call: PyTorch lets it use TF32
    by default, which rounds ``h`` and the kernels to 10 mantissa bits in
    every step's products.  The setting is process-wide, so it is taken
    and given back under a lock; only the RNN's own setting changes."""
    if device.type != "cuda":
        yield
        return
    rnn = torch.backends.cudnn.rnn
    with _fused_lock:
        saved = rnn.fp32_precision
        rnn.fp32_precision = "ieee"
        try:
            yield
        finally:
            rnn.fp32_precision = saved


def lstm_fused(x: torch.Tensor, weights: typing.Sequence[torch.Tensor],
               run_dtype: torch.dtype) -> torch.Tensor:
    """One direction through ``torch.lstm`` (cuDNN on the card) in
    ``run_dtype`` on ``weights`` (``[w_ih, w_hh, b_ih, b_hh]`` in
    ``run_dtype``); ``[B, T, H]`` f32."""
    h0 = x.new_zeros((1, x.shape[0], weights[1].shape[1]), dtype=run_dtype)
    with _full_f32_rnn(x.device) if run_dtype == torch.float32 else contextlib.nullcontext():
        out, _, _ = torch.lstm(x.to(run_dtype), (h0, h0), list(weights), True, 1, 0.0, False,
                               False, True)
    return out.float()


class _FusedWeights:
    """A direction's weights for ``lstm_fused``: rounded to the compute
    dtype, cast to the run dtype and, on the card, flattened into the one
    buffer cuDNN reads (else it compacts them on every call).  Built once
    and rebuilt when a parameter moves (``data_ptr``) or is written in
    place (its version counter)."""

    def __init__(self):
        self._built: typing.Dict[typing.Tuple[str, torch.dtype], tuple] = {}

    def get(self, name: str, cell: nn.LSTM, dtype: torch.dtype,
            run_dtype: torch.dtype) -> typing.List[torch.Tensor]:
        params = _cell_params(cell)
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return [p.to(dtype).to(run_dtype) for p in params]   # the gradient flows back
        stamp = tuple((p.data_ptr(), -1 if p.is_inference() else p._version) for p in params)
        with _fused_lock:
            hit = self._built.get((name, run_dtype))
            if hit is None or hit[0] != stamp:
                with torch.inference_mode(False), torch.no_grad():
                    weights = [p.detach().to(dtype).to(run_dtype, copy=True) for p in params]
                    if weights[0].is_cuda:
                        torch._cudnn_rnn_flatten_weight(
                            weights, 4, cell.input_size,
                            torch.backends.cudnn.rnn.get_cudnn_mode("LSTM"),
                            cell.hidden_size, 0, 1, True, False)
                hit = self._built[(name, run_dtype)] = (stamp, weights)
        return hit[1]


class BiLSTMClassifier(nn.Module):
    """``forward(tokens [B, T] int, lengths [B] int)`` -> f32 logits."""

    def __init__(self, vocab_size: int = 20000, embed_dim: int = 128, hidden_dim: int = 256,
                 num_classes: int = 2, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed = nn.Embedding(vocab_size, embed_dim, dtype=compute_dtype)
        self.fwd = nn.LSTM(embed_dim, hidden_dim, batch_first=True)
        self.bwd = nn.LSTM(embed_dim, hidden_dim, batch_first=True)
        self.hidden = nn.Linear(2 * hidden_dim, hidden_dim)
        self.head = nn.Linear(hidden_dim, num_classes)
        self._fused = _FusedWeights()

    def _direction(self, tokens, name, last, route) -> torch.Tensor:
        x = F.embedding(tokens, self.embed.weight)
        cell = getattr(self, name)
        if route == "plain":
            hs = lstm_plain(x, cell, self.compute_dtype)
        elif route in _RUN_DTYPES:
            run_dtype = _RUN_DTYPES[route]
            hs = lstm_fused(x, self._fused.get(name, cell, self.compute_dtype, run_dtype),
                            run_dtype)
        else:
            raise ValueError(f"route must be one of {LSTM_ROUTES}, got {route!r}")
        return hs[torch.arange(hs.shape[0], device=hs.device), last]

    def states(self, tokens: torch.Tensor, lengths: torch.Tensor,
               route: typing.Optional[str] = None) -> torch.Tensor:
        """The forward and reverse final hidden states, ``[B, 2H]`` f32.
        ``route``: one of ``LSTM_ROUTES``; by default ``"plain"`` on the
        CPU and ``CUDA_ROUTE`` on the card."""
        route = route or ("plain" if tokens.device.type == "cpu" else CUDA_ROUTE)
        steps = tokens.shape[1]
        tokens = tokens.long()
        lengths = lengths.long()
        t = torch.arange(steps, device=tokens.device)
        reverse = (steps - 1 - t[None, :] + lengths[:, None]) % steps   # flip_sequences
        last = (lengths - 1) % steps                                    # _select_last_carry
        return torch.cat([
            self._direction(tokens, "fwd", last, route),
            self._direction(torch.gather(tokens, 1, reverse), "bwd", last, route)], dim=-1)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                route: typing.Optional[str] = None) -> torch.Tensor:
        h = self.states(tokens, lengths, route)
        dt = self.compute_dtype
        h = F.relu(F.linear(h.to(dt), self.hidden.weight.to(dt), self.hidden.bias.to(dt)))
        return self.head(h.float())


def init_bilstm(module: BiLSTMClassifier, generator: torch.Generator) -> BiLSTMClassifier:
    """The port's initialiser: flax's defaults from ``generator``: the
    embedding's truncated normal of variance 1/embed_dim, lecun-normal
    input kernels, orthogonal recurrent kernels (one per gate), zero
    biases, lecun-normal Dense kernels."""
    embed_dim = module.embed.embedding_dim
    lecun_normal_(module.embed.weight, embed_dim, generator)
    for cell in (module.fwd, module.bwd):
        hidden = cell.hidden_size
        lecun_normal_(cell.weight_ih_l0, embed_dim, generator)
        with torch.no_grad():
            for gate in cell.weight_hh_l0.split(hidden, dim=0):
                nn.init.orthogonal_(gate, generator=generator)
            cell.bias_ih_l0.zero_()
            cell.bias_hh_l0.zero_()
    for layer in (module.hidden, module.head):
        lecun_normal_(layer.weight, layer.in_features, generator)
        with torch.no_grad():
            layer.bias.zero_()
    return module


@register_model_def("bilstm")
def build(vocab_size: int = 20000, embed_dim: int = 128, hidden_dim: int = 256,
          num_classes: int = 2, compute_dtype: str = "bfloat16") -> ModelDef:
    """``compute_dtype`` is the reference's bf16, or float32 for the plain
    f32 path."""
    dtype = _DTYPES[compute_dtype]
    arch = dict(vocab_size=vocab_size, embed_dim=embed_dim, hidden_dim=hidden_dim,
                num_classes=num_classes)
    # A dynamic sequence axis: the batcher pads it to a length bucket.
    schema = RecordSchema({"tokens": TensorSpec((None,), np.int32)})

    def make_module() -> BiLSTMClassifier:
        return BiLSTMClassifier(**arch, compute_dtype=dtype)

    def serve(module: BiLSTMClassifier, inputs, lengths):
        logits = module(inputs["tokens"], lengths["tokens"])
        return {"logits": logits,
                "label": torch.argmax(logits, dim=-1).to(torch.int32),
                "prob": torch.softmax(logits, dim=-1)}

    def init_fn(seed) -> BiLSTMClassifier:
        return init_bilstm(make_module(), torch.Generator().manual_seed(int(seed)))

    def load_fn(params) -> BiLSTMClassifier:
        if isinstance(params, BiLSTMClassifier):
            if params.compute_dtype == dtype:
                return params
            module = make_module()   # the same weights at this def's dtype
            state = params.state_dict()
            state["embed.weight"] = state["embed.weight"].to(dtype)
            module.load_state_dict(state)
            return module
        from flink_tensorflow_tpu_torch.models.convert import bilstm_from_flax

        return bilstm_from_flax(params, make_module())

    def loss_fn(module: BiLSTMClassifier, batch, generator):
        logits = module(batch["tokens"], batch["tokens_len"])
        labels = batch["label"].long()
        per_ex = F.cross_entropy(logits, labels, reduction="none")
        hits = (torch.argmax(logits, -1) == labels).float()
        loss, acc = weighted_metrics(per_ex, hits, batch.get("valid"))
        return loss, ({}, {"loss": loss, "accuracy": acc})

    return ModelDef(
        architecture="bilstm",
        config={**arch, "compute_dtype": compute_dtype},
        module=BiLSTMClassifier,
        input_schema=schema,
        methods={"serve": ModelMethod(name="serve", input_schema=schema,
                                      output_names=("logits", "label", "prob"), fn=serve,
                                      needs_lengths=True)},
        init_fn=init_fn,
        load_fn=load_fn,
        loss_fn=loss_fn,
        make_module=make_module,
    )
