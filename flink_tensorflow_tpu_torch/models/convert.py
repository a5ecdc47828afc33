"""Weight bridge: the JAX package's parameter trees -> torch modules.

Torch cannot replay ``jax.random`` init streams, so the same weights
reach both packages as numpy.

- The char transformer's tree is ``{"emb", "pos", "head", "ln_f",
  "layers": [{"ln1", "wq", ...}, ...]}`` with dense weights in ``(in,
  out)`` layout; the port's module keeps that layout (it computes
  ``h @ w``), so :func:`params_from_jax` only flattens names.  The
  ``head`` leaf is carried as given, never re-tied to ``emb``.
- Inception-v3's flax ``variables`` (``{"params": ..., "batch_stats":
  ...}``) follow flax's auto-naming (``ConvBN_0/Conv_0/kernel``,
  ``ConvBN_0/BatchNorm_0/{scale,bias}``, ``batch_stats/.../{mean,var}``,
  ``InceptionA_0``, ..., ``Dense_0``).  :func:`inception_from_flax`
  carries them into the port's module: conv kernels HWIO -> OIHW, the
  Dense kernel ``(in, out)`` -> ``(out, in)``.
- ResNet-50 (:func:`resnet_from_flax`) and Wide&Deep
  (:func:`widedeep_from_flax`) follow the same rules; an ``nn.Embed``
  table is carried as it is, and ``batch_stats`` land in the running
  buffers.
- LeNet (:func:`lenet_from_flax`): conv kernels HWIO -> OIHW, Dense
  kernels transposed; the module flattens in flax's (H, W, C) order, so
  ``Dense_0``'s rows carry over unpermuted.
- BiLSTM (:func:`bilstm_from_flax`): flax's per-gate kernels ``ii, if,
  ig, io`` (``[E, H]``, no bias) and ``hi, hf, hg, ho`` (``[H, H]``, with
  bias) are concatenated in gate order i, f, g, o and transposed into
  ``nn.LSTM``'s ``weight_ih_l0`` / ``weight_hh_l0``; flax's hidden-side
  bias is ``bias_hh_l0`` and ``bias_ih_l0`` is zero.  The bf16 embedding
  reaches numpy as ml_dtypes bf16, goes through f32 (exact) and is stored
  back in the module's dtype.
- A whole JAX train state (variables, an optax adam or sgd state, the
  step) becomes the port's with :func:`train_state_from_jax`, so both
  packages continue from the same step.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.parallel.dp import module_variables


def params_from_jax(np_tree: typing.Mapping[str, typing.Any]) -> typing.Dict[str, torch.Tensor]:
    """Flatten a (numpy or array-like) parameter tree into dotted
    state_dict names: dict keys join with ``.``, list items by index."""
    out: typing.Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, typing.Mapping):
            for key, child in node.items():
                walk(f"{prefix}{key}.", child)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(f"{prefix}{i}.", child)
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, dtype=np.float32))

    walk("", np_tree)
    return out


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def inception_from_flax(variables: typing.Mapping[str, typing.Any], module):
    """Load flax Inception-v3 ``variables`` (numpy or array-like leaves)
    into ``module`` (a ``models.zoo.inception.InceptionV3``)."""
    params, stats = variables["params"], variables["batch_stats"]
    state: typing.Dict[str, torch.Tensor] = {}

    def conv_bn(prefix: str, p, s) -> None:
        state[f"{prefix}.weight"] = _np(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1).contiguous()
        state[f"{prefix}.scale"] = _np(p["BatchNorm_0"]["scale"])
        state[f"{prefix}.bias"] = _np(p["BatchNorm_0"]["bias"])
        state[f"{prefix}.mean"] = _np(s["BatchNorm_0"]["mean"])
        state[f"{prefix}.var"] = _np(s["BatchNorm_0"]["var"])

    for i in range(len(module.stem)):
        conv_bn(f"stem.{i}", params[f"ConvBN_{i}"], stats[f"ConvBN_{i}"])
    counters: typing.Dict[str, int] = {}
    for b, block in enumerate(module.blocks):
        kind = type(block).__name__
        name = f"{kind}_{counters.get(kind, 0)}"
        counters[kind] = counters.get(kind, 0) + 1
        for c in range(len(block.convs)):
            conv_bn(f"blocks.{b}.convs.{c}", params[name][f"ConvBN_{c}"],
                    stats[name][f"ConvBN_{c}"])
    state["head.weight"] = _np(params["Dense_0"]["kernel"]).T.contiguous()
    state["head.bias"] = _np(params["Dense_0"]["bias"])
    module.load_state_dict(state)
    return module


def _dense(state: typing.Dict[str, torch.Tensor], prefix: str, p) -> None:
    state[f"{prefix}.weight"] = _np(p["kernel"]).T.contiguous()
    state[f"{prefix}.bias"] = _np(p["bias"])


def resnet_from_flax(variables: typing.Mapping[str, typing.Any], module):
    """Load flax ResNet ``variables`` into ``module`` (a
    ``models.zoo.resnet.ResNet``).  Flax names a block's layers in call
    order: ``Conv_0/BatchNorm_0`` (1x1), ``Conv_1/BatchNorm_1`` (3x3),
    ``Conv_2/BatchNorm_2`` (1x1 out), ``Conv_3/BatchNorm_3`` (projection)."""
    params, stats = variables["params"], variables["batch_stats"]
    state: typing.Dict[str, torch.Tensor] = {}

    def conv(prefix: str, p) -> None:
        state[f"{prefix}.weight"] = _np(p["kernel"]).permute(3, 2, 0, 1).contiguous()

    def bn(prefix: str, p, s) -> None:
        state[f"{prefix}.scale"] = _np(p["scale"])
        state[f"{prefix}.bias"] = _np(p["bias"])
        state[f"{prefix}.mean"] = _np(s["mean"])
        state[f"{prefix}.var"] = _np(s["var"])

    conv("stem", params["Conv_0"])
    bn("stem_bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    for b, block in enumerate(module.blocks):
        p, s = params[f"BottleneckBlock_{b}"], stats[f"BottleneckBlock_{b}"]
        layers = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
        if block.proj is not None:
            layers.append(("proj", "proj_bn"))
        for i, (c, n) in enumerate(layers):
            conv(f"blocks.{b}.{c}", p[f"Conv_{i}"])
            bn(f"blocks.{b}.{n}", p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"])
    _dense(state, "head", params["Dense_0"])
    module.load_state_dict(state)
    return module


def widedeep_from_flax(variables: typing.Mapping[str, typing.Any], module):
    """Load flax Wide&Deep ``variables`` into ``module`` (a
    ``models.zoo.widedeep.WideDeep``): ``wide``, ``embed/embedding``,
    ``Dense_0 .. Dense_{n-1}`` (hidden), ``Dense_{n}`` (out)."""
    params = variables["params"]
    state: typing.Dict[str, torch.Tensor] = {"embed.weight": _np(params["embed"]["embedding"])}
    _dense(state, "wide", params["wide"])
    n = len(module.hidden)
    for i in range(n):
        _dense(state, f"hidden.{i}", params[f"Dense_{i}"])
    _dense(state, "out", params[f"Dense_{n}"])
    module.load_state_dict(state)
    return module


def lenet_from_flax(variables: typing.Mapping[str, typing.Any], module):
    """Load flax LeNet ``variables`` into ``module`` (a
    ``models.zoo.lenet.LeNet``)."""
    params = variables["params"]
    state: typing.Dict[str, torch.Tensor] = {}
    for name, flax_name in (("conv1", "Conv_0"), ("conv2", "Conv_1")):
        state[f"{name}.weight"] = _np(params[flax_name]["kernel"]).permute(3, 2, 0, 1).contiguous()
        state[f"{name}.bias"] = _np(params[flax_name]["bias"])
    for name, flax_name in (("fc1", "Dense_0"), ("fc2", "Dense_1"), ("head", "Dense_2")):
        _dense(state, name, params[flax_name])
    module.load_state_dict(state)
    return module


def bilstm_from_flax(variables: typing.Mapping[str, typing.Any], module):
    """Load flax BiLSTM ``variables`` into ``module`` (a
    ``models.zoo.bilstm.BiLSTMClassifier``)."""
    params = variables["params"]
    state: typing.Dict[str, torch.Tensor] = {
        "embed.weight": _np(params["Embed_0"]["embedding"]).to(module.embed.weight.dtype)}
    for name, flax_name in (("fwd", "OptimizedLSTMCell_0"), ("bwd", "OptimizedLSTMCell_1")):
        cell = params[flax_name]
        state[f"{name}.weight_ih_l0"] = torch.cat(
            [_np(cell[f"i{g}"]["kernel"]) for g in "ifgo"], dim=1).T.contiguous()
        state[f"{name}.weight_hh_l0"] = torch.cat(
            [_np(cell[f"h{g}"]["kernel"]) for g in "ifgo"], dim=1).T.contiguous()
        state[f"{name}.bias_hh_l0"] = torch.cat([_np(cell[f"h{g}"]["bias"]) for g in "ifgo"])
        state[f"{name}.bias_ih_l0"] = torch.zeros_like(state[f"{name}.bias_hh_l0"])
    _dense(state, "hidden", params["Dense_0"])
    _dense(state, "head", params["Dense_1"])
    module.load_state_dict(state)
    return module


def _port_params(model_def, params_tree, batch_stats) -> typing.Dict[str, torch.Tensor]:
    """A flax ``params``-shaped tree (weights, or an optimizer moment) under
    the port's parameter names: loaded through the model's bridge."""
    variables = {"params": params_tree}
    if batch_stats is not None:
        variables["batch_stats"] = batch_stats
    return module_variables(model_def.load_fn(variables))["params"]


def train_state_from_jax(jax_state: typing.Mapping[str, typing.Any], model_def, *,
                         seed: int = 0) -> typing.Dict[str, typing.Any]:
    """The port's TrainState (``parallel/dp.py``) from a JAX one whose
    leaves are numpy (``jax.tree.map(np.asarray, state)``, the typed rng
    key dropped): the same variables, the optax state carried over
    (``(ScaleByAdamState(count, mu, nu), EmptyState())`` -> ``{"count",
    "mu", "nu"}``; sgd's empty states -> ``{}``) and the same ``step``.
    The rng becomes the port's integer ``seed``.  Host tensors; place them
    with ``parallel.mesh.replicate`` or ``.to(device)``."""
    variables = jax_state["variables"]
    stats = variables.get("batch_stats")
    port_vars = module_variables(model_def.load_fn(variables))
    opt_state: typing.Dict[str, typing.Any] = {}
    for part in jax_state["opt_state"]:
        if hasattr(part, "mu") and hasattr(part, "nu") and hasattr(part, "count"):
            opt_state = {
                "count": torch.tensor(int(np.asarray(part.count)), dtype=torch.int32),
                "mu": _port_params(model_def, part.mu, stats),
                "nu": _port_params(model_def, part.nu, stats),
            }
        elif len(part):
            raise ValueError(f"optimizer state {type(part).__name__} has no port counterpart "
                             "(the port carries optax adam and sgd states)")
    return {
        "variables": port_vars,
        "opt_state": opt_state,
        "step": torch.tensor(int(np.asarray(jax_state["step"])), dtype=torch.int32),
        "rng": int(seed),
    }
