"""nnstreamer_tpu_torch/ops/normalize.py against the JAX package's
``normalize_reference`` and its Pallas kernel (``fused_normalize(
force_pallas=True)``, interpret mode on the CPU), at the shapes of
tests/test_ops.py plus custom scale/offset to float32.

Tolerance: 0 (bitwise). All three compute an exact f32 subtraction of an
integer and the offset, one f32 product and one round-to-nearest-even
cast to the output dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops import normalize as jax_normalize
from nnstreamer_tpu_torch.ops import fused_normalize, normalize, normalize_plain

SHAPES = [(224, 224, 3), (8,), (3, 5, 7), (64, 1024)]
JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
       torch.float32: jnp.float32}


def _bits(a) -> np.ndarray:
    """Raw bits of a float array (numpy, JAX or torch) for a bitwise
    comparison."""
    if isinstance(a, torch.Tensor):
        t = a.view(torch.int32 if a.dtype == torch.float32 else torch.int16)
        return t.numpy()
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int16)


def _frame(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 255, shape, np.uint8,
                                                endpoint=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_jax_reference_and_pallas_kernel(shape, dtype):
    x = _frame(shape)
    got = normalize_plain(torch.from_numpy(x), dtype=dtype)
    ref = jax_normalize.normalize_reference(jnp.asarray(x), 1 / 127.5,
                                            127.5, JNP[dtype])
    kern = jax_normalize.fused_normalize(jnp.asarray(x), dtype=JNP[dtype],
                                         force_pallas=True)
    assert got.dtype == dtype and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(got), _bits(kern))


def test_custom_scale_offset_to_float32():
    x = np.array([[0, 255], [128, 64]], np.uint8)
    got = normalize_plain(torch.from_numpy(x), 2.0, 1.0, torch.float32)
    kern = jax_normalize.fused_normalize(jnp.asarray(x), scale=2.0,
                                         offset=1.0, dtype=jnp.float32,
                                         force_pallas=True)
    np.testing.assert_array_equal(_bits(got), _bits(kern))
    np.testing.assert_array_equal(got.numpy(),
                                  (x.astype(np.float32) - 1.0) * 2.0)


def test_every_byte_value_against_jax():
    """All 256 inputs, bf16 and f16: the roundings agree on every one."""
    x = np.arange(256, dtype=np.uint8)
    for dtype in (torch.bfloat16, torch.float16):
        got = normalize_plain(torch.from_numpy(x), dtype=dtype)
        ref = jax_normalize.normalize_reference(jnp.asarray(x), 1 / 127.5,
                                                127.5, JNP[dtype])
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_tensor_dispatches_to_plain_without_launch(shape):
    x = torch.from_numpy(_frame(shape, seed=1))
    before = normalize.launches
    got = fused_normalize(x)
    assert normalize.launches == before
    np.testing.assert_array_equal(_bits(got), _bits(normalize_plain(x)))


def test_cpu_non_contiguous_input():
    x = torch.from_numpy(_frame((16, 24)))[:, ::2]
    assert not x.is_contiguous()
    np.testing.assert_array_equal(_bits(fused_normalize(x)),
                                  _bits(normalize_plain(x.contiguous())))


def test_unsupported_output_dtype_raises():
    with pytest.raises(TypeError, match="float32, float16, bfloat16"):
        fused_normalize(torch.zeros(4, dtype=torch.uint8),
                        dtype=torch.float64)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel launch (or raises): stand in a
    CUDA-typed tensor and check that the plain version is not called."""
    calls = []
    monkeypatch.setattr(normalize, "normalize_plain",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(normalize, "_launch",
                        lambda x, s, o, d: ("launched", s, o, d))

    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.uint8

    assert normalize.fused_normalize(FakeCuda())[0] == "launched"
    assert calls == []
    FakeCuda.dtype = torch.float32
    with pytest.raises(TypeError, match="uint8"):
        normalize.fused_normalize(FakeCuda())


def test_new_port_modules_import_no_jax():
    """The modules this slice adds (and chip_smoke.py's imports) pull in
    nothing of JAX or of the JAX package, checked in a fresh
    interpreter; chip_smoke.py's function-level imports are read from
    its source."""
    import ast
    import os
    import subprocess
    import sys
    code = ("import sys, nnstreamer_tpu_torch.ops.normalize, "
            "nnstreamer_tpu_torch.models.mobilenet, "
            "nnstreamer_tpu_torch.models.convert, "
            "nnstreamer_tpu_torch.tensors.fetch, "
            "nnstreamer_tpu_torch.utils.flowmarks, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'nnstreamer_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "nnstreamer_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "ml_dtypes",
                        "nnstreamer_tpu"}
