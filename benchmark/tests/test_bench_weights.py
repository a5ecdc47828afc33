"""The weights both sides get: the one draw of the image configurations
bit for bit as it was, and the per-tensor maker a configuration may
choose, which fills the program's module in place, tensor by tensor,
with values that depend on ``(seed, index)`` alone.

The last test is for the card (``cuda``-marked; it skips without an
NVIDIA GPU): the per-tensor maker fills a module as large as
DeepSeek-V2-Lite in bf16 with no more memory beside it than its largest
tensor in float32.
"""

import json
import math
import os
import time

import pytest
import torch
from torch import nn

from benchmark import weights
from benchmark.tests.tiny import BENCH, CONFIGS
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def

CPU = torch.device("cpu")
SEED = 2**31 + 21


def _one_draw_as_it_was(config, seed, device):
    """The one-draw maker as the image cells' weights were first made,
    kept here as the yardstick of its bits."""
    with torch.device("meta"):
        module = weights.reference_class(config)(**weights.reference_kwargs(config))
    module = module.to_empty(device=device)
    kernels = [p for p in module.parameters() if p.dim() >= 2]
    vectors = {id(p) for p in kernels}
    gen = torch.Generator(device).manual_seed(weights.derive(seed, 11))
    with torch.no_grad():
        sizes = [p.numel() for p in kernels]
        draw = torch.randn(sum(sizes), generator=gen, device=device)
        gains = [math.sqrt((1.0 if p.dim() == 2 else 2.0) / p[0].numel()) for p in kernels]
        draw *= torch.repeat_interleave(torch.tensor(gains, device=device),
                                        torch.tensor(sizes, device=device))
        torch._foreach_copy_(kernels, [c.view_as(p) for c, p in
                                       zip(torch.split(draw, sizes), kernels)])
        for name, p in module.named_parameters():
            if id(p) not in vectors:
                p.fill_(1.0 if name.endswith("gamma") else 0.0)
        for name, b in module.named_buffers():
            b.fill_(1.0 if name.endswith("var") else 0.0)
    return module


def _config(name, **changes):
    """The configuration's file at the CPU tests' small sizes."""
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return {**json.load(f), **CONFIGS[name], **changes}


def _tensors(module):
    return list(module.parameters()) + list(module.buffers())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_image_configurations_get_the_same_bits_as_before(name):
    config = _config(name)
    assert not weights.per_tensor(config)
    made = _tensors(weights.reference_module(config, SEED, CPU))
    want = _tensors(_one_draw_as_it_was(config, SEED, CPU))
    assert len(made) == len(want)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(made, want))
    mdef = get_model_def(config["architecture"], **config["port"])
    program = weights.into_program(config, mdef.make_module(), SEED, CPU)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(program), want))


def test_per_tensor_values_depend_on_seed_and_index_not_on_order():
    shapes = [(48, 32), (32,), (3, 5, 3, 3), (32, 48), (48, 32)]
    names = ["emb", "norm_gamma", "conv", "head", "other"]

    def made(order):
        out = [torch.empty(s) for s in shapes]
        weights.fill_per_tensor([(i, names[i], out[i]) for i in order], SEED, torch.float32)
        return out

    forward, backward = made(range(5)), made(reversed(range(5)))
    assert all(torch.equal(a, b) for a, b in zip(forward, backward))
    assert torch.equal(forward[1], torch.ones(32))
    assert not torch.equal(forward[0], forward[4])          # same shape, another index
    # The same scales as the one draw: He's for a conv, sqrt(1 / fan_in) for a matrix.
    big = [torch.empty(512, 256), torch.empty(64, 32, 3, 3)]
    weights.fill_per_tensor([(0, "w", big[0]), (1, "c", big[1])], SEED, torch.float32)
    assert big[0].std().item() == pytest.approx(math.sqrt(1 / 256), rel=0.02)
    assert big[1].std().item() == pytest.approx(math.sqrt(2 / (32 * 9)), rel=0.02)


def test_per_tensor_program_holds_what_the_reference_makes_again():
    """A configuration that chooses the maker, in bf16: the program's bf16
    module, and a float32 one, hold the values the reference makes again,
    whole or a layer alone, widened to float32."""
    config = _config("resnet-50", weights="per_tensor")
    assert config["compute_dtype"] == "bfloat16"
    mdef = get_model_def(config["architecture"], **config["port"])
    low = weights.into_program(config, mdef.make_module().to(torch.bfloat16), SEED, CPU)
    wide = weights.into_program(config, mdef.make_module(), SEED, CPU)
    ref = weights.reference_module(config, SEED, CPU)
    for a, b, r in zip(_tensors(low), _tensors(wide), _tensors(ref)):
        assert a.dtype == torch.bfloat16 and b.dtype == r.dtype == torch.float32
        assert torch.equal(a.float(), r) and torch.equal(b, r)
    names = [n for n, _ in ref.named_parameters()]
    layer = weights.reference_tensors(config, SEED, CPU, lambda n: n.startswith("blocks.1."))
    assert layer and set(layer) < set(names)
    held = dict(ref.named_parameters())
    assert all(torch.equal(t, held[n]) for n, t in layer.items())
    # The one draw gives other values: the configuration's choice is read.
    assert not torch.equal(_tensors(weights.reference_module(_config("resnet-50"), SEED, CPU))[0],
                           _tensors(ref)[0])
    with pytest.raises(ValueError, match="cannot hold"):
        weights.into_program(config, mdef.make_module().to(torch.float16), SEED, CPU)


#: DeepSeek-V2-Lite's parameters (its config.json: 27 layers at 2048, MLA
#: with kv_lora_rank 512 and heads of 128 + 64 and 128, layer 0 dense at
#: 10944, 64 routed experts of 1408 and 2 shared, vocabulary 102,400,
#: untied head).
V2_LITE_PARAMETERS = 15_706_484_224


def v2_lite_shapes():
    """``(out, in)`` of each of DeepSeek-V2-Lite's tensors, as a plain
    linear layer each; a norm's vector is a ``(1, width)`` layer."""
    h, vocab, heads = 2048, 102400, 16
    shapes = [(vocab, h)]
    for layer in range(27):
        shapes += [(1, h), (heads * (128 + 64), h), (512 + 64, h), (1, 512),
                   (heads * (128 + 128), 512), (h, heads * 128), (1, h)]
        widths = [10944] if layer == 0 else [1408] * 64 + [2 * 1408]
        if layer:
            shapes.append((64, h))       # the router
        for w in widths:
            shapes += [(w, h), (w, h), (h, w)]
    return shapes + [(1, h), (vocab, h)]


def test_v2_lite_shapes_count_the_published_parameters():
    assert sum(o * i for o, i in v2_lite_shapes()) == V2_LITE_PARAMETERS


@pytest.mark.cuda
def test_per_tensor_fills_a_v2_lite_sized_bf16_module_beside_one_f32_tensor():
    """Peak allocated memory while the maker fills 15.7 billion bf16
    parameters: at most the module's bytes and its largest tensor in
    float32.  A tensor made again alone equals the one the module holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    card = torch.device("cuda", 0)
    with torch.device("meta"):
        stack = nn.Sequential(*(nn.Linear(i, o, bias=False, dtype=torch.bfloat16)
                                for o, i in v2_lite_shapes()))
    stack = stack.to_empty(device=card)
    params = list(stack.named_parameters())
    assert sum(p.numel() for _, p in params) == V2_LITE_PARAMETERS
    torch.cuda.synchronize(card)
    torch.cuda.reset_peak_memory_stats(card)
    held = torch.cuda.memory_allocated(card)
    largest = max(p.numel() for _, p in params) * 4
    t0 = time.monotonic()
    weights.fill_per_tensor([(i, n, p) for i, (n, p) in enumerate(params)], SEED, torch.bfloat16)
    torch.cuda.synchronize(card)
    seconds = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(card)
    print(f"v2-lite per-tensor fill: {len(params)} tensors, {V2_LITE_PARAMETERS} bf16 "
          f"parameters, module {held} bytes allocated ({2 * V2_LITE_PARAMETERS} nominal), "
          f"largest tensor in f32 {largest} bytes, peak {peak} bytes "
          f"({peak - held} above the module), {seconds!r} s, on {torch.cuda.get_device_name(card)}")
    # The caching allocator keeps a large segment's tail under 1 MiB with
    # its block, so the module holds a little more than its 2 bytes each.
    assert 2 * V2_LITE_PARAMETERS <= held <= 2 * V2_LITE_PARAMETERS + 2**20 * len(params)
    assert peak <= held + largest
    for index in (0, 40, len(params) - 1):
        name, p = params[index]
        again = torch.empty_like(p)
        weights.fill_per_tensor([(index, name, again)], SEED, torch.bfloat16)
        assert torch.equal(again, p), name
    del stack, params
    torch.cuda.empty_cache()
