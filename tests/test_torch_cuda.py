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
                                   (1, 7, 2, 8), (3, 33, 5, 72),
                                   (64, 196, 12, 64), (1, 1, 1, 64),
                                   (1, 65, 2, 64), (1, 50, 3, 20)])
def test_kernel_matches_plain(card, shape, dtype, tol):
    """The CUDA kernel against attention_plain on the card. bf16: two bf16
    ulps below 2 in magnitude (the plain version rounds the normalised p
    before p.v, the tensor-core kernel the unnormalised p of each key
    tile); f16 likewise with 3 more bits; f32: summation order only.
    S=1 and S=65 (one key past a 64-key tile) take the masked tail;
    D=20 (40-byte rows) takes element staging."""
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


@pytest.mark.parametrize("view,staging", [("fused", "vec16"),
                                          ("offset1", "element")])
def test_kernel_reads_strided_inputs(card, view, staging):
    """q/k/v as views of one fused [B, S, 3, H, D] projection: read
    through their strides, no copies. ``offset1`` shifts the projection's
    storage by one element, so no row is 16-byte aligned and the kernel
    stages with element loads."""
    shape = (2, 50, 3, 4, 32)
    n = int(np.prod(shape))
    flat = torch.randn(n + 1, device="cuda").bfloat16()
    qkv = (flat[:n] if view == "fused" else flat[1:]).view(shape)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    assert attention.plan(q, k, v) == ("tensor_core", staging)
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


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("shape", [(224, 224, 3), (8,), (3, 5, 7),
                                   (64, 1024), (4, 224, 224, 3),
                                   (1_000_003,), (15,), (0,)])
def test_normalize_kernel_matches_plain_bitwise(card, shape, dtype):
    """The normalize kernel against normalize_plain on the card, bitwise:
    both do an f32 subtraction, an f32 product and one round-to-nearest
    cast. Ragged sizes take the scalar tail."""
    from nnstreamer_tpu_torch.ops import normalize
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 255, shape, np.uint8,
                                      endpoint=True)).cuda()
    before = normalize.launches
    got = normalize.fused_normalize(x, dtype=dtype)
    torch.cuda.synchronize()
    assert normalize.launches == before + (1 if x.numel() else 0)
    want = normalize.normalize_plain(x, dtype=dtype)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_normalize_kernel_unaligned_and_strided(card, offset):
    """A view whose data pointer is not 16-byte aligned takes the scalar
    path; a non-contiguous view is made contiguous first. Custom
    scale/offset to f32, bitwise."""
    from nnstreamer_tpu_torch.ops import normalize
    raw = torch.randint(0, 256, (100_017,), dtype=torch.uint8,
                        device="cuda")
    x = raw[offset:]
    assert x.data_ptr() % 16 != 0
    got = normalize.fused_normalize(x, 2.0, 1.0, torch.float32)
    assert torch.equal(got, normalize.normalize_plain(x, 2.0, 1.0,
                                                      torch.float32))
    strided = raw[: 100_000].view(100, 1000)[:, ::3]
    assert not strided.is_contiguous()
    got = normalize.fused_normalize(strided)
    assert torch.equal(_bits(got), _bits(normalize.normalize_plain(strided)))


def test_normalize_kernel_refuses_non_uint8(card):
    from nnstreamer_tpu_torch.ops import normalize
    with pytest.raises(TypeError, match="uint8"):
        normalize.fused_normalize(torch.zeros(4, device="cuda"))


def test_submit_fetch_resolves_cuda_outputs_and_coalesces(card):
    """prefetch on CUDA outputs: every frame resolves to its own values,
    equal to .cpu(), and frames queued behind a slow copy batch share the
    next one (fewer RPCs than frames)."""
    from nnstreamer_tpu_torch.tensors import transfer as T
    T.fetch_stats(reset=True)
    T.set_simulated_rtt_ms(20.0)
    try:
        outs = []
        for i in range(32):
            a = torch.full((1001,), float(i), device="cuda") * 2.0
            b = torch.arange(6, device="cuda", dtype=torch.bfloat16) + i
            outs.append(((a, b), T.submit_fetch([a, b])))
        for (a, b), (pa, pb) in outs:
            assert isinstance(pa, T.PendingHost)
            np.testing.assert_array_equal(T.resolve(pa), a.cpu().numpy())
            got_b = T.resolve(pb)
            assert isinstance(got_b, torch.Tensor)
            assert got_b.dtype == torch.bfloat16
            assert torch.equal(got_b, b.cpu())
    finally:
        T.set_simulated_rtt_ms(0.0)
    stats = T.fetch_stats(reset=True)
    assert stats["frames"] == 32 and stats["arrays"] == 64
    assert stats["rpcs"] < 32 and stats["frames_per_rpc_avg"] > 1.0


def test_submit_fetch_waits_for_the_producer_stream(card):
    """The copy waits for the event recorded on the producer's stream:
    about 20 GEMMs queued on a side stream, then, with no host sync, a
    fetch of their result. A copy that ran early would read memory the
    GEMMs had not yet written."""
    from nnstreamer_tpu_torch.tensors import transfer as T
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = torch.ones(2048, 2048, device="cuda")
        for _ in range(20):
            x = x @ x / 2048.0  # stays all ones, exactly
        y = x.sum(dim=0)
        pending = T.submit_fetch([y])
    got = T.resolve(pending[0])
    np.testing.assert_array_equal(got, np.full(2048, 2048.0, np.float32))


def test_small_mobilenet_line_on_card(card):
    """A small MobileNet line with prefetch-host on the card against the
    same line on the CPU: outputs arrive as fetched host arrays, and the
    bf16 logits agree within 5 % of the largest |logit| (cuDNN and the
    CPU round bf16 at other points)."""
    from nnstreamer_tpu_torch.tensors.transfer import PendingHost
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=3:96:96,framerate=0/1")
    line = (f"tensortestsrc caps={caps} pattern=random num-buffers=4 "
            "! queue ! tensor_filter framework=torch-cuda {} "
            'model="zoo://mobilenet_v2?width=0.35&size=96" '
            "prefetch-host=true ! appsink name=out")
    gpu = pt.parse_launch(line.format("")).run(timeout=120)
    cpu = pt.parse_launch(line.format("accelerator=true:cpu")).run(
        timeout=120)
    assert len(gpu["out"].buffers) == len(cpu["out"].buffers) == 4
    for g, c in zip(gpu["out"].buffers, cpu["out"].buffers):
        assert isinstance(g.chunks[0]._data, (PendingHost, np.ndarray))
        gh, ch = g.chunks[0].host(), c.chunks[0].host()
        assert isinstance(gh, np.ndarray) and gh.shape == (1001,)
        np.testing.assert_allclose(gh, ch, rtol=0,
                                   atol=0.05 * np.abs(ch).max())
