"""The port's sparse ops and elements (nnstreamer_tpu_torch/ops/sparse.py,
elements/sparse.py) against the JAX package's, on the CPU.

Ops: ``pack``/``unpack`` run as torch ops on CPU tensors, held against
the JAX jitted ops and the numpy oracle ``pack_reference`` on seeded
inputs; every comparison is exact (a pack or an unpack moves values, it
computes nothing). ``fetch_packed`` brings the result back in one
copy, nnz included.

Bytes: ``sparse_encode`` gives the JAX package's bytes for f32, u8, f16,
i16 and bf16 (the JAX side in ``ml_dtypes``, the port a CPU
``torch.bfloat16`` with the same bits), in absolute and diff mode, with
NaN payloads and +-0.0 flips; each package decodes the other's bytes to
the same values, bit for bit.

Elements: ``tensor_sparse_enc ! tensor_sparse_dec`` lines in both
packages give the same chunks; the device paths (``density<1`` on a
chunk on the device, ``device=true``) run here on the CPU by treating a
CPU tensor as device-resident (``is_device_tensor`` patched) and the
decode device as the CPU: the same torch ops the card runs, held
against the host path byte for byte, including the ``nnz > capacity``
fall-back.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.elements import sparse as nt_sparse
from nnstreamer_tpu.ops import sparse as nt_ops
from nnstreamer_tpu_torch.elements import sparse as pt_sparse
from nnstreamer_tpu_torch.ops import sparse as pt_ops
from nnstreamer_tpu_torch.tensors import buffer as pt_buffer


def _bits(v) -> bytes:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().tobytes()
        v = v.numpy()
    return np.ascontiguousarray(v).tobytes()


def _sparse_frame(shape, density, dtype, seed):
    """Seeded values with about ``density`` of them non-zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 4
    x[rng.random(shape) >= density] = 0
    return x.astype(dtype) if dtype != "bfloat16" else x


def _pair(x, dtype):
    """(JAX host value, port host value) with the same bytes."""
    if dtype == "bfloat16":
        nv = x.astype(ml_dtypes.bfloat16)
        return nv, torch.from_numpy(nv.view(np.int16).copy()).view(
            torch.bfloat16)
    return x, x.copy()


# -- ops -------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [1, 17, 64, 400])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_pack_matches_jax_and_the_oracle(dtype, capacity):
    import jax.numpy as jnp
    x = _sparse_frame((20, 20), 0.1, "float32", seed=capacity)
    x[3, 4] = -0.0   # a zero: never packed
    x[5, 6] = np.nan  # non-zero: packed
    if dtype == "int32":
        x = np.nan_to_num(x).astype(np.int32)
    nv, pv = _pair(x, dtype)
    nidx, nvals, nnnz = nt_ops.pack(jnp.asarray(nv).reshape(-1), capacity)
    flat = (pv.reshape(-1) if isinstance(pv, torch.Tensor)
            else torch.from_numpy(pv.reshape(-1)))
    pidx, pvals, pnnz = pt_ops.fetch_packed(*pt_ops.pack(flat, capacity))
    assert pnnz == int(nnnz)
    assert pidx.dtype == np.uint32
    assert pidx.tobytes() == np.asarray(nidx).tobytes()
    assert pvals.tobytes() == np.asarray(nvals).tobytes()
    ridx, rvals = nt_ops.pack_reference(np.asarray(nv))
    assert pt_ops.pack_reference(np.asarray(nv))[0].tobytes() == \
        ridx.tobytes()
    keep = min(capacity, len(ridx))
    assert pidx[:keep].tobytes() == ridx[:keep].tobytes()
    assert pvals[:keep].tobytes() == np.asarray(rvals)[:keep].tobytes()


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
def test_unpack_matches_jax(dtype):
    import jax.numpy as jnp
    size = 300
    rng = np.random.default_rng(4)
    idx = np.sort(rng.choice(size, 40, replace=False)).astype(np.uint32)
    vals = (rng.standard_normal(40) * 5).astype(np.float32)
    vals[3] = 0.0    # a real zero value: masked like a pad
    vals[4] = -0.0   # compares equal to 0: masked too, in both
    vals[5] = np.nan
    if dtype == "uint8":
        vals = np.nan_to_num(np.abs(vals)).astype(np.uint8)
    idx = np.concatenate([idx, np.zeros(24, np.uint32)])  # pads (0, 0)
    vals = np.concatenate([vals, np.zeros(24, vals.dtype)])
    nv, pv = _pair(vals, dtype)
    want = nt_ops.unpack(jnp.asarray(idx), jnp.asarray(nv), size)
    got = pt_ops.unpack(idx, pv if isinstance(pv, torch.Tensor)
                        else torch.from_numpy(pv), size, "cpu")
    assert got.shape == (size,)
    assert _bits(got) == np.asarray(want).tobytes()


def test_pack_counts_only_card_runs():
    pt_ops.reset_counts()
    idx, vals, nnz = pt_ops.pack(torch.arange(8.0), 4)
    pt_ops.fetch_packed(idx, vals, nnz)
    pt_ops.unpack(np.arange(3, dtype=np.uint32), np.ones(3, np.float32), 8)
    assert (pt_ops.packs, pt_ops.unpacks, pt_ops.pack_d2h_bytes) == (0, 0, 0)


def test_fetch_packed_is_one_copy_with_nnz():
    """nnz rides in the same blob as the pairs: its count is read from
    the fetched bytes, not from a separate sync."""
    x = torch.tensor([0.0, 2.0, 0.0, 3.0, 4.0])
    idx, vals, nnz = pt_ops.pack(x, 2)
    hidx, hvals, n = pt_ops.fetch_packed(idx, vals, nnz)
    assert n == 3 and hidx.tolist() == [1, 3] and hvals.tolist() == [2, 3]


# -- bytes -----------------------------------------------------------------


def _special(dtype):
    x = _sparse_frame((6, 7, 3), 0.3, "float32", seed=9)
    if dtype in ("float32", "float16", "bfloat16"):
        x[0, 0, 0] = np.nan
        x[0, 1, 0] = -0.0
        x[0, 2, 0] = np.inf
        x[0, 3, 0] = -np.inf
        if dtype == "float32":
            # a NaN with a payload: the bits must survive
            x.reshape(-1).view(np.uint32)[10] = 0x7FC0_1234
    elif dtype == "uint8":
        x = np.abs(x * 20).astype(np.uint8)
    else:
        x = (x * 100).astype(dtype)
    return x.astype(dtype) if dtype not in ("bfloat16",) else x


DTYPES = ["float32", "uint8", "float16", "int16", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_encode_bytes_equal(dtype):
    nv, pv = _pair(_special(dtype), dtype)
    data = pt_sparse.sparse_encode(pv)
    assert data == nt_sparse.sparse_encode(nv)
    assert _bits(pt_sparse.sparse_decode(data)) == \
        np.asarray(nt_sparse.sparse_decode(data)).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_diff_mode_bytes_equal(dtype):
    """Diff mode compares bits: NaN payloads and +-0.0 flips are changes
    and survive the round trip exactly."""
    ref = _special(dtype)
    cur = ref.copy()
    flat = cur.reshape(-1)
    flat[5] = flat[5] + 1 if dtype != "uint8" else flat[5] ^ 1
    if dtype in ("float32", "float16"):
        flat[1] = -flat[1] if flat[1] == 0 else 0.0  # -0.0 <-> +0.0
        flat[7] = np.nan
    nref, pref = _pair(ref, dtype)
    ncur, pcur = _pair(cur, dtype)
    data = pt_sparse.sparse_encode(pcur, pref)
    assert data == nt_sparse.sparse_encode(ncur, nref)
    got = pt_sparse.sparse_decode(data, pref)
    assert _bits(got) == _bits(pcur)
    assert _bits(got) == np.asarray(
        nt_sparse.sparse_decode(data, nref)).tobytes()


def test_diff_reference_mismatch_raises_in_both():
    a = np.zeros(4, np.float32)
    for mod in (nt_sparse, pt_sparse):
        with pytest.raises(ValueError, match="reference mismatch"):
            mod.sparse_encode(a, np.zeros(5, np.float32))


# -- elements ----------------------------------------------------------------


CAPS = ("other/tensors,format=static,num_tensors=1,"
        "types=(string){t},dimensions=(string)3:16:16")


def _run(pkg, desc, frames):
    pipe = pkg.parse_launch(desc)
    pipe.start()
    for f in frames:
        pipe["in"].push_buffer(pkg.Buffer.from_arrays([f]))
    pipe["in"].end_stream()
    assert pipe.wait_eos(30)
    pipe.stop()
    return pipe["out"].buffers


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
def test_enc_dec_line_equal_in_both(dtype):
    frames = [_sparse_frame((16, 16, 3), 0.05, dtype, seed=i)
              for i in range(4)]
    if dtype == "uint8":
        frames = [np.abs(f.astype(np.float32) * 30).astype(np.uint8)
                  for f in frames]
    pairs = [_pair(f, dtype) for f in frames]
    desc = (f'appsrc name=in caps="{CAPS.format(t=dtype)}" '
            "! tensor_sparse_enc name=e ! tensor_sparse_dec ! appsink name=out")
    got_nt = _run(nt, desc, [n for n, _ in pairs])
    got_pt = _run(pt, desc, [p for _, p in pairs])
    assert len(got_pt) == len(frames)
    for (_, p), g, w in zip(pairs, got_pt, got_nt):
        assert _bits(g.chunks[0].host()) == _bits(p)
        assert _bits(g.chunks[0].host()) == \
            np.asarray(w.chunks[0].host()).tobytes()


def test_encoder_chunks_equal_in_both():
    f = _sparse_frame((16, 16, 3), 0.05, "float32", seed=1)
    desc = (f'appsrc name=in caps="{CAPS.format(t="float32")}" '
            "! tensor_sparse_enc ! appsink name=out")
    got_nt = _run(nt, desc, [f])[0].chunks[0]
    got_pt = _run(pt, desc, [f.copy()])[0].chunks[0]
    assert got_pt.host().tobytes() == np.asarray(got_nt.host()).tobytes()
    assert got_pt.meta.nnz == got_nt.meta.nnz > 0


@pytest.fixture
def cpu_as_device(monkeypatch):
    """A CPU tensor counts as device-resident, and device=true decodes
    onto the CPU: the device paths' torch ops run here."""
    monkeypatch.setattr(pt_buffer, "is_device_tensor",
                        lambda x: isinstance(x, torch.Tensor))
    monkeypatch.setattr(pt_sparse, "decode_device",
                        lambda: torch.device("cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int16"])
def test_device_pack_bytes_equal_host_path(cpu_as_device, dtype):
    x = _sparse_frame((16, 16, 3), 0.05, "float32", seed=3)
    x[0, 0, 0] = np.nan
    x[0, 0, 1] = -0.0
    if dtype == "int16":
        x = np.nan_to_num(x * 10).astype(np.int16)
    nv, pv = _pair(x, dtype)
    t = pv if isinstance(pv, torch.Tensor) else torch.from_numpy(pv)
    el = pt_sparse.TensorSparseEnc(density=0.1)
    out = el.transform(pt.Buffer([pt_buffer.Chunk(t)]))
    assert out.chunks[0].host().tobytes() == nt_sparse.sparse_encode(nv)


def test_device_pack_overflow_takes_the_host_path(cpu_as_device):
    x = _sparse_frame((16, 16, 3), 0.5, "float32", seed=5)
    el = pt_sparse.TensorSparseEnc(density=0.1)
    out = el.transform(pt.Buffer([pt_buffer.Chunk(torch.from_numpy(x))]))
    data = out.chunks[0].host().tobytes()
    assert data == nt_sparse.sparse_encode(x)
    assert out.chunks[0].meta.nnz > 0.1 * x.size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_decode_equals_the_input(cpu_as_device, dtype):
    x = _sparse_frame((16, 16, 3), 0.05, "float32", seed=6)
    x[1, 1, 1] = np.nan
    nv, pv = _pair(x, dtype)
    dec = pt_sparse.TensorSparseDec(device=True)
    dec.transform_caps(pt.Caps(
        "other/tensors,format=sparse,framerate=(fraction)0/1"))
    data = np.frombuffer(nt_sparse.sparse_encode(nv), np.uint8)
    out = dec.transform(pt.Buffer([pt_buffer.Chunk(data)]))
    got = out.chunks[0].raw
    assert isinstance(got, torch.Tensor) and got.shape == (16, 16, 3)
    assert _bits(got) == _bits(pv)
