"""The port on the card: tests that need a CUDA device.

Each skips without one. This file imports nothing of JAX, so it also runs
where JAX is not installed; tests/conftest.py does import JAX, so there
run it without the conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as pt
from nnstreamer_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2.0 ** -6),
                                       (torch.float16, 2.0 ** -9),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(1, 196, 12, 64), (2, 1000, 4, 128),
                                   (1, 7, 2, 8), (3, 33, 5, 72)])
def test_kernel_matches_plain(card, shape, dtype, tol):
    """The CUDA kernel against attention_plain on the card. bf16: two bf16
    ulps below 2 in magnitude (the plain version rounds the normalised p
    before p.v, the kernel keeps it in f32); f16 likewise with 3 more
    bits; f32: summation order only."""
    rng = np.random.default_rng(7)
    q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype) for _ in range(3)]
    before = attention.launches
    got = attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.attention_plain(q, k, v)
    assert got.dtype == dtype and got.shape == shape
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_kernel_reads_strided_inputs(card):
    """q/k/v as views of one fused [B, S, 3, H, D] projection: read
    through their strides, no copies."""
    qkv = torch.randn(2, 50, 3, 4, 32, device="cuda").bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = attention.fused_attention(q, k, v)
    want = attention.attention_plain(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -6


def test_mask_launches_nothing(card):
    q = torch.randn(1, 16, 2, 8, device="cuda")
    mask = torch.ones(1, 2, 16, 16, dtype=torch.bool, device="cuda").tril()
    before = attention.launches
    got = attention.fused_attention(q, q, q, mask=mask)
    assert attention.launches == before
    want = attention.dot_product_attention(q, q, q, mask=mask)
    assert torch.equal(got, want)


@pytest.mark.parametrize("unique", [False, True])
def test_tensortestsrc_device_pool(card, unique):
    """device=true cycles a pool of frames on the card; unique=true adds
    the frame counter (mod 199, plus 1) on the card, as the JAX package
    does."""
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=4,framerate=0/1")
    line = (f"tensortestsrc caps={caps} pattern=random seed=2 pool-size=2 "
            f"unique={str(unique).lower()} num-buffers=3 "
            "device={} ! appsink name=out")
    host = pt.parse_launch(line.format("false")).run(timeout=30)
    dev = pt.parse_launch(line.format("true")).run(timeout=30)
    pool = [b.chunks[0].host() for b in host["out"].buffers[:2]]
    for i, b in enumerate(dev["out"].buffers):
        assert b.chunks[0].is_device
        want = pool[i % 2] + np.uint8(i % 199 + 1) if unique else pool[i % 2]
        assert b.chunks[0].host().tobytes() == want.tobytes()


def test_small_vit_line_on_card(card):
    """A small ViT line on the card launches the kernel once per encoder
    block and frame, and its logits equal the CPU run's within the bf16
    bound of tests/test_torch_vit.py (3e-2)."""
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=3:64:64,framerate=0/1")
    model = ('"zoo://vit?size=64&d_model=64&layers=4&heads=4&classes=10'
             '&attn=pallas"')
    line = (f"tensortestsrc caps={caps} pattern=random num-buffers=3 "
            f"! tensor_filter framework=torch-cuda {{}} model={model} "
            "! appsink name=out")
    attention.launches = 0
    gpu = pt.parse_launch(line.format("")).run(timeout=120)
    assert attention.launches == 4 * 3
    cpu = pt.parse_launch(line.format("accelerator=true:cpu")).run(
        timeout=120)
    for g, c in zip(gpu["out"].buffers, cpu["out"].buffers):
        assert g.chunks[0].is_device
        np.testing.assert_allclose(g.chunks[0].host(), c.chunks[0].host(),
                                   rtol=0, atol=3e-2)
