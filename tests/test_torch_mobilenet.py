"""nnstreamer_tpu_torch/models/mobilenet.py against the JAX package's
MobileNet-v2, with the JAX model's variables carried over by
models/convert.py.

Width 0.35 at 96x96 (even: flax pads the stride-2 convs (0, 1)) and at
97x97 (odd: (1, 1)), 1001 classes. The JAX variables' BatchNorm
statistics and scale/bias are overwritten with values drawn from a numpy
seed (mean ~ N(0, 0.5), var ~ U(0.5, 2), scale ~ U(0.5, 1.5), bias ~
N(0, 0.1)) before converting: at init they are 0/1/1/0, and a swapped
mean/var or a missing epsilon would pass.

Tolerances:
  * float32 (``MobileNetV2(dtype=float32)`` on both sides): 1e-4
    absolute on logits of magnitude ~1; the two compute the same f32
    arithmetic with other summation orders (observed ~1e-6).
  * bfloat16 (the zoo path, uint8 frame in): 2e-2 absolute plus equal
    top-1. Both round every conv and BatchNorm output to bf16; a
    rounding that lands on the other side of a tie moves one activation
    by one bf16 ulp, and the logits by far less (observed ~1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu.models.mobilenet import MobileNetV2 as JaxMobileNet
from nnstreamer_tpu_torch.models import zoo
from nnstreamer_tpu_torch.models.convert import mobilenet_params_from_jax
from nnstreamer_tpu_torch.models.mobilenet import (MobileNetV2, make_apply,
                                                   same_pads)

WIDTH = 0.35
F32_ATOL = 1e-4
BF16_ATOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng, draw):
    return {k: _perturb(v, rng, draw) if isinstance(v, dict)
            else draw(k, v, rng) for k, v in tree.items()}


def _draw(key, leaf, rng):
    shape = np.shape(leaf)
    if key == "mean":
        return rng.normal(0.0, 0.5, shape).astype(np.float32)
    if key == "var":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if key == "scale":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if key == "bias" and len(shape) == 1 and shape[0] != 1001:
        return rng.normal(0.0, 0.1, shape).astype(np.float32)
    return np.asarray(leaf)


def _variables(size):
    """The JAX zoo model's variables at ``size``, BatchNorm perturbed."""
    _, variables, _, _ = jax_zoo.build("mobilenet_v2", width=str(WIDTH),
                                       size=str(size))
    tree = jax.tree.map(np.asarray, jax.device_get(variables))
    rng = np.random.default_rng(size)
    return {"params": _perturb(tree["params"], rng, _draw),
            "batch_stats": _perturb(tree["batch_stats"], rng, _draw)}


@pytest.fixture(scope="module", params=[96, 97], ids=["even96", "odd97"])
def case(request):
    size = request.param
    variables = _variables(size)
    frames = np.random.default_rng(100 + size).integers(
        0, 255, (3, size, size, 3), np.uint8, endpoint=True)
    return size, variables, mobilenet_params_from_jax(variables), frames


def _port(state_dict, **kw):
    m = MobileNetV2(num_classes=1001, width=WIDTH, **kw)
    m.load_state_dict(state_dict)  # strict: every key maps
    return m.eval()


def test_float32_matches_jax(case):
    _, variables, sd, frames = case
    x = frames.astype(np.float32) / 127.5 - 1.0
    want = JaxMobileNet(num_classes=1001, width=WIDTH,
                        dtype=jnp.float32).apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = _port(sd, dtype=torch.float32)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 1001)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)


def test_bfloat16_apply_matches_jax(case):
    _, variables, sd, frames = case
    want = np.asarray(JaxMobileNet(num_classes=1001, width=WIDTH).apply(
        variables, jnp.asarray(frames).astype(jnp.bfloat16) / 127.5 - 1.0))
    with torch.inference_mode():
        got = make_apply(False)(_port(sd), torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == (3, 1001)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_batched_equals_per_frame(case):
    _, _, sd, frames = case
    model, apply_fn = _port(sd), make_apply(False)
    with torch.inference_mode():
        batch = apply_fn(model, torch.from_numpy(frames))
        single = [apply_fn(model, torch.from_numpy(f)) for f in frames]
    for b, s in zip(batch, single):
        assert s.shape == (1001,)
        np.testing.assert_allclose(b.numpy(), s.numpy(), rtol=0, atol=1e-5)


def test_top1_matches_jax_argmax(case):
    """``top1=1``: an int32 [1] per frame and [B, 1] per batch, equal to
    the argmax of the logits path, as tests/test_models.py checks it for
    the JAX model."""
    size, variables, sd, frames = case
    logits = np.asarray(JaxMobileNet(num_classes=1001, width=WIDTH).apply(
        variables, jnp.asarray(frames).astype(jnp.bfloat16) / 127.5 - 1.0))
    model, top1 = _port(sd), make_apply(True)
    with torch.inference_mode():
        one = top1(model, torch.from_numpy(frames[0]))
        many = top1(model, torch.from_numpy(frames))
    assert one.dtype == torch.int32 and one.shape == (1,)
    assert int(one[0]) == int(logits[0].argmax())
    assert many.shape == (3, 1)
    np.testing.assert_array_equal(many[:, 0].numpy(), logits.argmax(-1))


@pytest.mark.parametrize("top1", ["0", "1"])
def test_zoo_build_contract_matches_jax(top1):
    _, _, jin, jout = jax_zoo.build("mobilenet_v2", width="0.35",
                                    size="96", top1=top1)
    _, module, pin, pout = zoo.build("mobilenet_v2", width="0.35",
                                     size="96", top1=top1)
    assert str(pin) == str(jin) and str(pout) == str(jout)
    assert isinstance(module, MobileNetV2)


def test_full_width_parameter_count_matches_jax():
    """Width 1.0, 224x224, 1001 classes: the torch module holds as many
    parameters as the JAX ``params`` tree (shapes only, no forward)."""
    shapes = jax.eval_shape(
        lambda: JaxMobileNet(num_classes=1001, width=1.0).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.bfloat16)))
    jax_params = sum(int(np.prod(leaf.shape))
                     for leaf in jax.tree.leaves(shapes["params"]))
    jax_stats = sum(int(np.prod(leaf.shape))
                    for leaf in jax.tree.leaves(shapes["batch_stats"]))
    model = MobileNetV2(num_classes=1001, width=1.0)
    assert sum(p.numel() for p in model.parameters()) == jax_params
    assert sum(b.numel() for b in model.buffers()) == jax_stats
    assert jax_params == 3_506_153


@pytest.mark.parametrize("size,k,stride,want", [
    (96, 3, 2, (0, 1)), (97, 3, 2, (1, 1)), (96, 3, 1, (1, 1)),
    (7, 1, 1, (0, 0)), (3, 3, 2, (1, 1)), (4, 3, 2, (0, 1))])
def test_same_padding_is_flax_rule(size, k, stride, want):
    assert same_pads(size, k, stride) == want
