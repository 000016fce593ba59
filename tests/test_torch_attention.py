"""nnstreamer_tpu_torch/ops/attention.py against the JAX package's Pallas
attention kernel.

The JAX side runs the real Pallas body in interpret mode
(``fused_attention(..., interpret=True)``), as tests/test_ops.py does.
The port's CPU path is ``attention_plain``, the plain PyTorch version the
CUDA kernel is held against on the card.

Tolerances:
  * float32: 1e-5 absolute. Both sides compute in f32 and differ only in
    summation order (observed <= 5e-7).
  * bfloat16: 2**-7 absolute, one bf16 ulp for outputs below 2 in
    magnitude. Both sides round p and o to bf16; the f32 sums may round
    to neighbouring bf16 values (observed <= 2**-9).
"""
import os

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops.attention import fused_attention as jax_fused
from nnstreamer_tpu_torch.ops import attention as port

SHAPES = [(2, 196, 4, 32), (1, 196, 2, 64), (1, 128, 2, 128), (1, 7, 2, 8)]
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture
def no_launches():
    port.launches = 0
    yield
    assert port.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_interpret(shape, dtype):
    qkv = _qkv(shape, seed=shape[1] + shape[3])
    want = jax_fused(*[jnp.asarray(x, jnp.dtype(dtype)) for x in qkv],
                     interpret=True)
    got = port.attention_plain(
        *[torch.from_numpy(x).to(getattr(torch, dtype)) for x in qkv])
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=TOL[dtype])


def test_cpu_wrapper_takes_plain_version(no_launches):
    q, k, v = [torch.from_numpy(x).bfloat16() for x in _qkv((1, 196, 12, 64), 1)]
    assert torch.equal(port.fused_attention(q, k, v),
                       port.attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_takes_stock_flax_path(dtype, no_launches):
    """A mask is outside the kernel's contract: the wrapper returns flax's
    masked attention (f32: 1e-6; bf16: one ulp, 2**-7) and launches
    nothing."""
    q, k, v = _qkv((1, 16, 2, 8), seed=0)
    mask = np.tril(np.ones((1, 2, 16, 16), bool))
    jdt = jnp.dtype(dtype)
    want = nn.dot_product_attention(
        *[jnp.asarray(x, jdt) for x in (q, k, v)], mask=jnp.asarray(mask))
    got = port.fused_attention(
        *[torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)],
        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=1e-6 if dtype == "float32" else 2.0 ** -7)


def test_bias_takes_stock_flax_path(no_launches):
    q, k, v = _qkv((1, 9, 2, 8), seed=4)
    bias = np.random.default_rng(5).standard_normal((1, 2, 9, 9)).astype(
        np.float32)
    want = nn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                    bias=jnp.asarray(bias))
    got = port.fused_attention(*map(torch.from_numpy, (q, k, v)),
                               bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "shape", "stride",
                                  "mixed_dtype", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    q = torch.zeros(1, 4, 2, 8)
    k, v = q.clone(), q.clone()
    if case == "head_dim":
        q = k = v = torch.zeros(1, 4, 2, port.MAX_HEAD_DIM + 1)
    elif case == "dtype":
        q = k = v = torch.zeros(1, 4, 2, 8, dtype=torch.float64)
    elif case == "shape":
        k = torch.zeros(1, 5, 2, 8)
    elif case == "stride":
        q = torch.zeros(1, 4, 8, 2).transpose(2, 3)
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "device":
        q = k = v = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises((TypeError, ValueError)):
        port.fused_attention(q, k, v)


def _view(kind, shape, dtype):
    b, s, h, d = shape
    if kind == "contiguous":
        return [torch.zeros(shape, dtype=dtype) for _ in range(3)]
    if kind == "offset1":  # storage offset of one element
        n = b * s * h * d
        return [torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
                for _ in range(3)]
    if kind == "fused_qkv":  # views of one [B, S, 3, H, D] projection
        return list(torch.zeros(b, s, 3, h, d, dtype=dtype).unbind(2))
    # rows D + 1 apart: the head stride is odd
    return [torch.zeros(b, s, h, d + 1, dtype=dtype)[..., :d]
            for _ in range(3)]


@pytest.mark.parametrize("view", ["contiguous", "offset1", "fused_qkv",
                                  "padded_rows"])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("d", [8, 20, 64, 72, 128])
def test_plan_routes_by_dtype_and_alignment(d, dtype, view):
    """The wrapper's routing, decided in Python with no card: f32 takes
    the CUDA-core kernel; bf16/f16 the tensor-core kernel, staged with
    16-byte cp.async only where every row starts 16-byte aligned and
    D*itemsize is a multiple of 16, else with element loads."""
    q, k, v = _view(view, (2, 5, 2, d), getattr(torch, dtype))
    got = port.plan(q, k, v)
    if dtype == "float32":
        assert got == ("cuda_core", "element")
        return
    aligned = view in ("contiguous", "fused_qkv") and d * 2 % 16 == 0
    assert got == ("tensor_core", "vec16" if aligned else "element")


def test_launch_counts_survive_concurrent_replays(monkeypatch):
    """Pipeline threads replay graphs (and launch eagerly) at once; each
    count goes through one lock, so no launch is lost: 8 threads x 2000
    replays of a 12-launch tally and 2000 eager launches each, with a
    short switch interval to force interleaving."""
    import collections
    import sys
    import threading

    from nnstreamer_tpu_torch.ops import _tally
    monkeypatch.setattr(port, "launches", 0)
    tally = collections.Counter({"attention": 12})

    def work():
        for _ in range(2000):
            _tally.replayed(tally)
            _tally.launched("attention")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert port.launches == 8 * 2000 * 13


def test_module_imports_no_jax():
    """The port's attention module (and the package) import nothing of
    JAX or of the JAX package, checked in a fresh interpreter."""
    import subprocess
    import sys
    code = ("import sys, nnstreamer_tpu_torch, nnstreamer_tpu_torch.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'nnstreamer_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
