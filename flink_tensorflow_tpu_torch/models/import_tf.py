"""Weight import from external checkpoints (TF SavedModel / name maps).

Port of ``flink_tensorflow_tpu/models/import_tf.py``.  The port cannot run
a TF model zoo GraphDef either, so parity is weight-level: this module
maps external ``{variable_name: ndarray}`` dicts onto the port's variable
trees.

- :func:`read_savedmodel_variables` — needs TensorFlow: loads a
  SavedModel and returns ``{variable_path: ndarray}``.  Without
  TensorFlow (neither this package nor its test machines carry it) it
  raises the reference's clear ``ImportError``.
- :func:`assign_by_name` — pure: matches external names onto a variable
  tree (nested mappings of tensors or arrays: ``parallel.dp.
  module_variables``' ``{"params": {name: tensor}, "batch_stats": ...}``,
  or a JAX-layout numpy tree before ``models/convert.py`` carries it into
  a module) by normalized path, with the reference's override rules,
  strict shape checks and report of what did not match.  A torch leaf
  takes the matched value as a tensor of the leaf's dtype; any other
  leaf takes the array as it came.
"""

from __future__ import annotations

import re
import typing

import numpy as np

from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef


def read_savedmodel_variables(path: str) -> typing.Dict[str, np.ndarray]:
    """Load all variables of a TF SavedModel as ``{name: ndarray}``."""
    try:
        import tensorflow as tf  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "reading TF SavedModels requires tensorflow, which is not "
            "installed in this environment; export the checkpoint to a "
            "name->array dict (np.savez) on a machine with TF and use "
            "assign_by_name(), or train natively (models.zoo)"
        ) from exc
    loaded = tf.saved_model.load(path)
    # A plain tf.Module restore has no .variables attribute: collect from
    # the object if present, else from the signatures' concrete functions.
    variables = getattr(loaded, "variables", None)
    if variables is None:
        seen = {}
        for sig in loaded.signatures.values():
            for v in sig.variables:
                seen[id(v)] = v
        variables = list(seen.values())
    return {v.name.split(":")[0]: v.numpy() for v in variables}


def _flatten(tree, prefix=()) -> typing.Iterator[typing.Tuple[typing.Tuple[str, ...], typing.Any]]:
    if isinstance(tree, typing.Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _set_in(tree: dict, path: typing.Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def _normalize(name: str) -> str:
    """Canonical form for matching: lowercase, digits kept, separators
    unified, common TF/flax synonyms folded."""
    n = name.lower().replace("/", ".").replace(":", ".")
    n = re.sub(r"\b(weights|w)\b", "kernel", n)
    n = re.sub(r"\b(biases|b)\b", "bias", n)
    n = n.replace("batchnorm", "batch_norm").replace("moving_mean", "mean")
    n = n.replace("moving_variance", "var").replace("gamma", "scale").replace("beta", "bias")
    return n


def _as_leaf(template, value):
    """``value`` in the template leaf's kind: a tensor of its dtype for a
    torch leaf, the array as it came otherwise."""
    import torch

    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(value)).to(template.dtype)
    return np.asarray(value)


def assign_by_name(
    variables: typing.Any,
    external: typing.Mapping[str, np.ndarray],
    *,
    rules: typing.Sequence[typing.Tuple[str, str]] = (),
    strict: bool = True,
) -> typing.Any:
    """A copy of ``variables`` with leaves replaced by matching entries of
    ``external``.

    Matching: each external name is regex-rewritten through ``rules`` (in
    order), normalized, and compared against the normalized tree path
    (``params.conv1.weight``, ``params.Conv_0.kernel``); an exact
    normalized match plus equal shapes wins.  ``strict=True`` raises if
    any tree leaf stays unmatched; unmatched EXTERNAL entries are always
    reported in the error, to help write rules."""
    import copy

    flat = list(_flatten(variables))
    leaf_by_path = dict(flat)
    by_norm: typing.Dict[str, typing.List[typing.Tuple[str, ...]]] = {}
    for path, _ in flat:
        by_norm.setdefault(_normalize(".".join(path)), []).append(path)

    out = copy.deepcopy(variables)
    matched: typing.Set[typing.Tuple[str, ...]] = set()
    unmatched_external = []
    for name, value in external.items():
        renamed = name
        for pattern, repl in rules:
            renamed = re.sub(pattern, repl, renamed)
        hit = None
        for path in by_norm.get(_normalize(renamed), []):
            # Normalization folds synonyms ('beta'/'b' -> 'bias'): a path
            # already claimed is not overwritten by a second external
            # entry — the next candidate is tried instead.
            if path in matched:
                continue
            if tuple(np.shape(leaf_by_path[path])) == tuple(np.shape(value)):
                hit = path
                break
        if hit is None:
            unmatched_external.append(name)
            continue
        _set_in(out, hit, _as_leaf(leaf_by_path[hit], value))
        matched.add(hit)

    missing = [".".join(p) for p, _ in flat if p not in matched]
    if strict and missing:
        raise ValueError(
            f"unmatched model variables: {missing[:10]}{'...' if len(missing) > 10 else ''}; "
            f"unmatched external entries: {unmatched_external[:10]} — add rules=[(pattern, repl), ...]"
        )
    return out


def import_savedmodel(path: str, model_def: ModelDef, *,
                      rules: typing.Sequence[typing.Tuple[str, str]] = ()) -> Model:
    """SavedModel -> a zoo Model with the imported weights (TF required).
    The template is the def's module on the meta device: only its names
    and shapes are read (every leaf is replaced)."""
    import torch

    from flink_tensorflow_tpu_torch.parallel.dp import module_variables

    external = read_savedmodel_variables(path)
    with torch.device("meta"):
        template = module_variables(model_def.make_module())
    variables = assign_by_name(template, external, rules=rules)
    module = model_def.make_module()
    module.load_state_dict({**variables["params"], **variables["batch_stats"]})
    return Model(model_def.architecture, module.eval(), model_def.methods,
                 metadata={"architecture": model_def.architecture,
                           "config": dict(model_def.config)})
