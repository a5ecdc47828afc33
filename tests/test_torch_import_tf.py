"""The port's ``models/import_tf.py`` held to the reference's.

Twins of ``tests/test_import_and_multihost.py``'s ``assign_by_name`` cases:
the same external ``{name: ndarray}`` dicts are matched onto the same
trees in both packages.  LeNet's flax-layout tree goes through both
``assign_by_name`` functions and then, as the port carries any JAX
weights, through ``models/convert.py:lenet_from_flax`` into the port's
module, where the two results must be equal bit for bit.  The port's own
variable tree (``parallel.dp.module_variables``: torch leaves under
``state_dict`` names) takes external names the same way.  Without
TensorFlow both readers raise the reference's ``ImportError``.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax

from flink_tensorflow_tpu.models import get_model_def as jget
from flink_tensorflow_tpu.models import import_tf as jimport
from flink_tensorflow_tpu_torch.models import import_tf
from flink_tensorflow_tpu_torch.models.convert import lenet_from_flax
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel.dp import module_variables


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def numbered(template, name=lambda path: "/".join(path)):
    """An external checkpoint with ``template``'s paths (TF-style
    separators) and recognizable values: leaf i is all i."""
    return {name(path): np.full(np.shape(leaf), float(i), np.float32)
            for i, (path, leaf) in enumerate(import_tf._flatten(template))}


def lenet_template():
    mdef = jget("lenet")
    return numpy_tree(jax.jit(mdef.init_fn)(jax.random.key(0)))


class TestAssignByName:
    def test_lenet_import_by_names(self):
        template = lenet_template()
        external = numbered(template)
        jmerged = jimport.assign_by_name(template, external)
        pmerged = import_tf.assign_by_name(template, external)
        for i, (path, leaf) in enumerate(import_tf._flatten(pmerged)):
            assert float(np.ravel(leaf)[0]) == float(i), path
        # Carried into the port's module, both merges are the same weights.
        pdef = get_model_def("lenet")
        want = lenet_from_flax(numpy_tree(jmerged), pdef.make_module()).state_dict()
        got = lenet_from_flax(pmerged, pdef.make_module()).state_dict()
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k

    def test_the_port_s_own_tree_takes_state_dict_names(self):
        variables = module_variables(get_model_def("lenet").make_module())
        external = numbered(variables, name=lambda path: "/".join(path).replace(".", "/"))
        merged = import_tf.assign_by_name(variables, external)
        pairs = zip(import_tf._flatten(merged), import_tf._flatten(variables))
        for i, ((path, leaf), (_, tmpl)) in enumerate(pairs):
            assert isinstance(leaf, torch.Tensor), path
            assert leaf.dtype == tmpl.dtype and leaf.shape == tmpl.shape, path
            assert float(leaf.reshape(-1)[0]) == float(i), path
        # A copy: the template's tensors are untouched.
        assert float(variables["params"]["conv1.bias"].abs().sum()) != float(
            merged["params"]["conv1.bias"].abs().sum())

    def test_strict_reports_missing(self):
        template = lenet_template()
        for assign in (jimport.assign_by_name, import_tf.assign_by_name):
            with pytest.raises(ValueError, match="unmatched model variables"):
                assign(template, {"nope/kernel": np.zeros((1,))})
        with pytest.raises(ValueError, match=r"unmatched external entries: \['nope/kernel'\]"):
            import_tf.assign_by_name(
                module_variables(get_model_def("lenet").make_module()),
                {"nope/kernel": np.zeros((1,))})

    def test_rules_rewrite_names(self):
        mdef = jget("widedeep", hash_buckets=10, embed_dim=2, hidden=(4,))
        template = numpy_tree(jax.jit(mdef.init_fn)(jax.random.key(0)))
        external = {"model/" + "/".join(path): np.asarray(leaf)
                    for path, leaf in import_tf._flatten(template)}
        jmerged = jimport.assign_by_name(template, external, rules=[(r"^model/", "")])
        pmerged = import_tf.assign_by_name(template, external, rules=[(r"^model/", "")])
        assert jax.tree.structure(pmerged) == jax.tree.structure(template)
        for (jp, jl), (pp, pl) in zip(import_tf._flatten(jmerged), import_tf._flatten(pmerged)):
            assert jp == pp and np.array_equal(np.asarray(jl), pl)

    def test_read_savedmodel_variables_roundtrip(self, tmp_path):
        tf = pytest.importorskip("tensorflow")
        path = str(tmp_path / "sm")

        class M(tf.Module):
            def __init__(self):
                self.w = tf.Variable(tf.fill((2, 3), 5.0), name="w")

            @tf.function(input_signature=[tf.TensorSpec([None, 2], tf.float32)])
            def serve(self, x):
                return {"y": x @ self.w}

        m = M()
        tf.saved_model.save(m, path, signatures={"serving_default": m.serve})
        (name, value), = import_tf.read_savedmodel_variables(path).items()
        assert value.shape == (2, 3) and float(value[0, 0]) == 5.0


class TestWithoutTensorFlow:
    @pytest.fixture(autouse=True)
    def no_tensorflow(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "tensorflow", None)  # import raises

    def test_the_readers_raise_the_reference_s_import_error(self, tmp_path):
        messages = []
        for read in (jimport.read_savedmodel_variables, import_tf.read_savedmodel_variables):
            with pytest.raises(ImportError, match="requires tensorflow") as info:
                read(str(tmp_path))
            messages.append(str(info.value))
        assert messages[1] == messages[0]

    def test_import_savedmodel_raises_before_building_anything(self, tmp_path):
        with pytest.raises(ImportError, match="assign_by_name"):
            import_tf.import_savedmodel(str(tmp_path), get_model_def("lenet"))


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
