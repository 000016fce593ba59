"""nnstreamer_tpu_torch/models/vit.py against the JAX package's ViT, with
the JAX model's weights carried over by models/convert.py.

A small config (64x64 frames, patch 16, d_model 64, 2 layers, 4 heads,
10 classes) keeps each test to seconds. Frames are seeded numpy uint8.

Tolerances:
  * float32 (the JAX ViT built with dtype=float32, fused=True, against the
    port's ViT in float32): 1e-5 absolute on logits of magnitude ~1. The
    two compute the same f32 arithmetic in another order (observed 1e-6).
  * bfloat16 (the zoo path, uint8 frame in): 3e-2 absolute on the logits,
    plus an identical argmax. bf16 keeps 8 bits; the frameworks round
    their bf16 intermediates (GELU, the q·k products, Dense outputs) at
    different points, which moves logits by a few bf16 ulps after two
    blocks (observed <= 8e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu.models.vit import ViT as JaxViT
from nnstreamer_tpu_torch.models import zoo
from nnstreamer_tpu_torch.models.convert import vit_params_from_jax
from nnstreamer_tpu_torch.models.vit import ViT, apply_vit
from nnstreamer_tpu_torch.ops import attention

CFG = dict(size="64", d_model="64", layers="2", heads="4", classes="10")
DIMS = dict(patch=16, d_model=64, layers=2, heads=4, classes=10)
BF16_ATOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: tier-1 runs six test workers on shared cores,
    and timing-sensitive tests in the other workers must not starve."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    apply_fn, params, _, _ = jax_zoo.build("vit", attn="pallas", **CFG)
    tree = jax.tree.map(np.asarray, jax.device_get(params))
    return apply_fn, params, vit_params_from_jax(tree)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    return rng.integers(0, 255, (4, 64, 64, 3), np.uint8, endpoint=True)


def _port(state_dict, **kw):
    m = ViT(size=64, **DIMS, **kw)
    m.load_state_dict(state_dict)  # strict: every key maps
    return m.eval()


def test_float32_matches_jax_vit(jax_model, frames):
    _, params, sd = jax_model
    x = frames.astype(np.float32) / 127.5 - 1.0
    want = JaxViT(**DIMS, dtype=jnp.float32, fused=True).apply(
        params, jnp.asarray(x))
    with torch.inference_mode():
        got = _port(sd, dtype=torch.float32, fused=True)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("batched", [False, True], ids=["frame", "batch"])
def test_bf16_zoo_path_matches_jax(jax_model, frames, batched):
    apply_fn, params, sd = jax_model
    model = _port(sd, fused=True)
    inputs = [frames] if batched else list(frames)
    for x in inputs:
        want = np.asarray(apply_fn(params, jnp.asarray(x)))
        with torch.inference_mode():
            got = apply_vit(model, torch.from_numpy(x)).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_stock_and_pallas_attention_agree(jax_model, frames):
    """attn=stock and attn=pallas share one set of weights and agree to
    bf16 rounding (mirrors tests/test_ops.py's toggle test)."""
    _, _, sd = jax_model
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        stock = apply_vit(_port(sd, fused=False), x)
        fused = apply_vit(_port(sd, fused=True), x)
    np.testing.assert_allclose(stock.numpy(), fused.numpy(), rtol=0,
                               atol=BF16_ATOL)
    np.testing.assert_array_equal(stock.argmax(-1), fused.argmax(-1))


def test_zoo_contract():
    apply_fn, model, in_info, out_info = zoo.build("vit", attn="pallas",
                                                   **CFG)
    assert tuple(in_info[0].shape) == (64, 64, 3)
    assert str(in_info[0].type) == "uint8"
    assert tuple(out_info[0].shape) == (10,)
    assert all(b.attn.fused for b in model.blocks)
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (64, 64, 3), np.uint8, endpoint=True))
    attention.launches = 0
    with torch.inference_mode():
        out = apply_fn(model, frame)
        batch = apply_fn(model, torch.stack([frame, frame]))
    assert attention.launches == 0  # CPU tensors take the plain version
    assert out.shape == (10,) and out.dtype == torch.float32
    assert batch.shape == (2, 10)
    np.testing.assert_allclose(batch[0].numpy(), out.numpy(), atol=1e-6)


def test_zoo_attn_auto_is_stock_and_typo_raises():
    _, model, _, _ = zoo.build("vit", **CFG)
    assert not any(b.attn.fused for b in model.blocks)
    with pytest.raises(ValueError, match="attn"):
        zoo.build("vit", attn="flash", **CFG)


def test_seeded_init_follows_flax_distributions():
    """Same seed, same weights; kernels are LeCun-normal truncated at two
    standard deviations, biases zero, LayerNorm ones/zeros."""
    _, a, _, _ = zoo.build("vit", seed="3", **CFG)
    _, b, _, _ = zoo.build("vit", seed="3", **CFG)
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.blocks[0].mlp_in.weight  # fan_in 64
    std = (1 / 64) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std
    assert abs(w.std().item() - (1 / 64) ** 0.5) < 0.1 * (1 / 64) ** 0.5
    assert torch.equal(a.blocks[0].ln0.weight, torch.ones(64))
    assert not a.blocks[0].mlp_in.bias.any()
