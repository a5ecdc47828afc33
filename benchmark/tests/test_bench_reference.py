"""The plain references against the program at small sizes on the CPU,
in float32, with the benchmark's own weights on both sides; and the
reference count against the published figures."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import check, weights
from benchmark.reference import count, inception_v3, resnet50
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import dp
from flink_tensorflow_tpu_torch.parallel.optim import adam

CPU = torch.device("cpu")

CASES = {
    "inception": ({"reference": {"module": "inception_v3", "class": "InceptionV3",
                                 "kwargs": {"num_classes": 10}}, "image_size": 75},
                  ("inception_v3", {"num_classes": 10, "image_size": 75, "uint8_input": True,
                                    "compute_dtype": "float32"})),
    "resnet": ({"reference": {"module": "resnet50", "class": "ResNet50",
                              "kwargs": {"num_classes": 10, "width": 8,
                                         "stage_sizes": [1, 2, 1, 1]}}, "image_size": 32},
               ("resnet50", {"num_classes": 10, "image_size": 32, "width": 8,
                             "stage_sizes": (1, 2, 1, 1), "uint8_input": True,
                             "compute_dtype": "float32"})),
}


def _pair(case, seed=2**31 + 3):
    config, (arch, kw) = CASES[case]
    ref = weights.reference_module(config, seed, CPU)
    mdef = get_model_def(arch, **kw)
    module = weights.load_into(mdef.make_module(), ref)
    # Pixels 0 and 255 only: the program normalises its input in bf16
    # whatever the compute dtype, and these two values come out the same
    # in bf16 and f32, so both sides see the same input.
    pixels = 255 * np.random.default_rng(seed).integers(0, 2, (4, config["image_size"],
                                                                config["image_size"], 3), np.uint8)
    return config, ref, mdef, module, pixels


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_forward_equals_the_program_in_float32(case):
    _, ref, mdef, module, pixels = _pair(case)
    ours = check.reference_logits(ref, pixels, CPU)
    model = mdef.to_model(module)
    with torch.no_grad():
        theirs = model.method("serve").fn(model.params, {"image": torch.from_numpy(pixels)})
    theirs = theirs["logits"].numpy()
    assert ours.std() > 1e-3
    # Only float32 rounding in another order separates them.
    np.testing.assert_allclose(theirs, ours, atol=1e-5 * np.abs(ours).max(), rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_train_steps_equal_the_programs_in_float32(case):
    config, ref, mdef, module, pixels = _pair(case)
    labels = np.array([1, 3, 5, 7], np.int32)
    rng = 12345
    opt = adam(1e-3)
    variables = dp.module_variables(module)
    state = {"variables": variables, "opt_state": opt.init(variables["params"]),
             "step": torch.zeros((), dtype=torch.int32), "rng": rng}
    p0 = [p.detach().clone() for p in ref.parameters()]
    step = dp.make_train_step(mdef, opt)
    batch = {"image": torch.from_numpy(pixels), "label": torch.from_numpy(labels),
             "valid": torch.ones(4)}
    state, metrics = step(state, batch, 0)
    prog_losses = [float(metrics["loss"])]
    grad = [state["opt_state"]["mu"][n] / 0.1 for n, _ in module.named_parameters()]
    losses, first, after, moments = check.reference_steps(
        ref, [(pixels, labels)], rng=rng, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, device=CPU)
    names = [n for n, _ in module.named_parameters()]
    delta = [state["variables"]["params"][n] - p for n, p in zip(names, p0)]
    m = 0.9997 if case == "inception" else 0.9
    stats = [state["variables"]["batch_stats"][n] for n, _ in module.named_buffers()]
    prog_moments = [(a / (1 - m), (b - m) / (1 - m)) for a, b in zip(stats[0::2], stats[1::2])]
    numbers = check.train_numbers(prog_losses, losses, grad, first, delta,
                                  [a - p for a, p in zip(after, p0)], prog_moments, moments)
    assert len(moments) == len(prog_moments)
    # The program's batch norm takes E[x^2] - E[x]^2; at 75 px Inception's
    # last blocks are 1x1, so their moments come from 4 values, and that
    # cancellation is the largest difference left in float32.  Adam's
    # first step is lr x sign(g), so the update reads that noise too.
    tol = {"inception": (1e-3, 0.1, 0.02, 0.1), "resnet": (1e-5, 1e-3, 0.01, 1e-3)}[case]
    assert numbers["loss_gap"] < tol[0] and numbers["grad_gap"] < tol[1]
    assert numbers["update_gap"] < tol[2] and numbers["moments_err"] < tol[3]


def test_dropout_draws_are_the_programs():
    """Both sides draw the mask from a generator seeded by the step."""
    config, ref, *_ = _pair("inception")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 75, 75, 3), np.uint8))
    gen = lambda: torch.Generator().manual_seed(check.fold_in(99, 0))  # noqa: E731
    a = ref(x, train=True, generator=gen())
    b = ref(x, train=True, generator=gen())
    c = ref(x, train=True, generator=torch.Generator().manual_seed(check.fold_in(99, 1)))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert check.fold_in(99, 0) == dp.fold_in(99, 0)


def test_count_matches_the_published_figures():
    inc = count.count(inception_v3.InceptionV3, {"num_classes": 1000, "compute_dtype": "bfloat16"},
                      batch=1, image_size=299, train=False)
    res = count.count(resnet50.ResNet50, {"num_classes": 1000, "compute_dtype": "bfloat16"},
                      batch=1, image_size=224, train=False)
    # The program's pricer reads Inception at 11.47 GFLOP a record; the
    # paper family at about 5.7 GMAC; ResNet-50 at 4.1 GMAC (He et al.).
    assert inc.flops / 1e9 == pytest.approx(11.43, rel=0.01)
    assert res.flops / 2e9 == pytest.approx(4.09, rel=0.01)
    assert inc.flops == pytest.approx(inc.total_flops) and res.bytes > 0
    trained = count.count(resnet50.ResNet50, {"num_classes": 1000, "compute_dtype": "bfloat16"},
                          batch=2, image_size=224, train=True)
    assert 2.9 < trained.flops / res.flops < 3.0   # the stem needs no input gradient
    assert all(w.least_s > 0 for w in trained.work)


#: ``(flops, bytes, least_s)`` a record, as the image count read before
#: it became a use of ``count_work`` (the same FLOP counter and byte
#: sizes): the four must not move by a bit.
IMAGE_COUNTS = {
    "inception-75-forward": (402996416.0, 45438374.0, 1.3563693731343284e-05),
    "resnet-tiny-train-4": (3800064.0, 339846.0, 1.014465671641791e-07),
    "inception-299-forward": (11426432192.0, 97930774.0, 2.9961502999260523e-05),
    "resnet50-224-train-256": (24299077632.0, 110262348.125, 3.980849062325129e-05),
}
IMAGE_CASES = {
    "inception-75-forward": (inception_v3.InceptionV3, {"num_classes": 10, "dropout": 0.2},
                             1, 75, False),
    "resnet-tiny-train-4": (resnet50.ResNet50, {"num_classes": 10, "width": 8,
                                                "stage_sizes": [1, 1, 1, 1]}, 4, 32, True),
    "inception-299-forward": (inception_v3.InceptionV3, {"num_classes": 1000, "dropout": 0.2},
                              1, 299, False),
    "resnet50-224-train-256": (resnet50.ResNet50, {"num_classes": 1000, "width": 64,
                                                   "stage_sizes": [3, 4, 6, 3]}, 256, 224, True),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_the_image_count_reads_as_before_to_the_bit(case):
    cls, kwargs, batch, size, train = IMAGE_CASES[case]
    got = count.count(cls, {**kwargs, "compute_dtype": "bfloat16"}, batch=batch,
                      image_size=size, train=train)
    assert (got.flops, got.bytes, got.least_s) == IMAGE_COUNTS[case]
    assert got.total_flops == got.flops


def test_count_work_prices_any_call_with_its_matmul_dtype():
    with torch.device("meta"):
        a, b = torch.zeros(3, 64, 32), torch.zeros(32, 16)

    def run():
        a @ b

    wide = count.count_work(run, compute_dtype="bfloat16", records=3)
    narrow = count.count_work(run, compute_dtype="bfloat16", records=3, matmul_dtype="bfloat16")
    assert wide.flops == narrow.flops == 2 * 64 * 32 * 16
    assert wide.bytes == 4 * (64 * 32 * 3 + 32 * 16 + 64 * 16 * 3) / 3
    assert narrow.bytes == wide.bytes / 2


def test_fp8_control_is_coarser_than_exact():
    _, ref, *_ = _pair("inception")
    from benchmark.reference import arith

    pixels = np.random.default_rng(1).integers(0, 256, (3, 75, 75, 3), np.uint8)
    exact = check.reference_logits(ref, pixels, CPU)
    low = check.reference_logits(ref, pixels, CPU, arith=arith.Fp8())
    numbers = check.forward_numbers(exact, low, low.argmax(1))
    assert 0.01 < numbers["logit_err"] < 10
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    y = arith.Fp8().conv(x, w, (1, 1), (1, 1))
    gx, gw = torch.autograd.grad(y.sum(), (x, w))
    ex, ew = torch.autograd.grad(F.conv2d(x, w, None, 1, 1).sum(), (x, w))
    assert 0 < (gx - ex).abs().max() < 0.2 * ex.abs().max()
    assert 0 < (gw - ew).abs().max() < 0.2 * ew.abs().max()
