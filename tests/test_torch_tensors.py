"""nnstreamer_tpu_torch/tensors and pipeline/basic.py against the JAX
package: type tables, chunks, and tensortestsrc frames (byte-identical)."""
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu_torch.tensors import Buffer, Chunk, TensorType


@pytest.mark.parametrize("name", [str(t) for t in nt.TensorType])
def test_type_table_matches_jax_package(name):
    j, p = nt.TensorType.from_string(name), pt.TensorType.from_string(name)
    assert int(p) == int(j)
    assert p.element_size == j.element_size
    assert p.torch_dtype.itemsize == p.element_size
    assert TensorType.from_dtype(p.torch_dtype) is p
    if name != "bfloat16":
        assert p.np_dtype == j.np_dtype
        assert TensorType.from_dtype(p.np_dtype) is p


def test_bf16_has_no_numpy_dtype_and_stays_a_tensor():
    with pytest.raises(TypeError, match="bfloat16"):
        TensorType.BFLOAT16.np_dtype
    c = Chunk(torch.ones(3, dtype=torch.bfloat16))
    assert c.type is TensorType.BFLOAT16 and c.nbytes == 6
    host = c.host()
    assert isinstance(host, torch.Tensor) and host.dtype == torch.bfloat16
    assert not c.is_device


def test_chunk_residency_host_and_device():
    arr = np.arange(6, dtype=np.int16).reshape(2, 3)
    c = Chunk(arr)
    assert not c.is_device and c.host() is arr
    assert c.to_info().shape == (2, 3) and str(c.type) == "int16"
    t = c.device("cpu")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.int16
    assert np.array_equal(Chunk(t).host(), arr)
    raw = Chunk(b"abc")
    assert raw.shape == (3,) and raw.nbytes == 3
    assert raw.host().tobytes() == b"abc"
    buf = Buffer.from_arrays([arr, t], pts=7)
    assert buf.nbytes == 24 and str(buf.to_infos()) == str(
        nt.Buffer.from_arrays([arr, arr]).to_infos())


@pytest.mark.parametrize("pattern", ["random", "counter", "zeros", "ones"])
@pytest.mark.parametrize("types,dims", [
    ("uint8", "3:8:8"), ("float32,int16", "4:2,5"), ("int64", "6")])
def test_tensortestsrc_frames_byte_identical(pattern, types, dims):
    caps = (f"other/tensors,format=static,num_tensors={len(types.split(','))},"
            f'types=(string)"{types}",dimensions=(string)"{dims}",'
            "framerate=(fraction)30/1")
    line = (f"tensortestsrc caps={caps} pattern={pattern} seed=9 "
            "num-buffers=3 ! appsink name=out")
    want = nt.parse_launch(line).run(timeout=30)["out"].buffers
    got = pt.parse_launch(line).run(timeout=30)["out"].buffers
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert (g.pts, g.duration) == (w.pts, w.duration)
        for cw, cg in zip(w.chunks, g.chunks):
            hw, hg = cw.host(), cg.host()
            assert hg.dtype == hw.dtype and hg.shape == hw.shape
            assert hg.tobytes() == hw.tobytes()


def test_tensortestsrc_device_pool_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=4,framerate=0/1")
    pipe = pt.parse_launch(f"tensortestsrc caps={caps} device=true "
                           "num-buffers=1 ! appsink")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipe.run(timeout=30)


@pytest.mark.parametrize("leaky,expect", [("upstream", [0, 1]),
                                          ("downstream", [3, 4])])
def test_leaky_queue_matches_jax_package(leaky, expect):
    """A full leaky queue drops the incoming (upstream) or the oldest
    (downstream) buffer, as the JAX package's queue does."""
    results = []
    for pkg in (nt, pt):
        q = pkg.make_element("queue", max_size_buffers=2, leaky=leaky,
                             backend="python")
        for i in range(5):
            q.chain(q.sinkpad, pkg.Buffer.from_arrays(
                [np.full(1, i, np.uint8)]))
        results.append([int(b.chunks[0].host()[0]) for b in q._q.queue])
    assert results[0] == results[1] == expect


def test_appsrc_capsfilter_queue_chain():
    """appsrc ! capsfilter ! queue ! appsink delivers every buffer in order
    and negotiates the caps the JAX package negotiates."""
    caps = ("other/tensors,format=static,num_tensors=1,types=float32,"
            "dimensions=2,framerate=0/1")
    negotiated = []
    for pkg in (nt, pt):
        pipe = pkg.parse_launch(f"appsrc name=src caps={caps} ! {caps} "
                                "! queue ! appsink name=out")
        pipe.start()
        for i in range(3):
            pipe["src"].push_buffer(pkg.Buffer.from_arrays(
                [np.full(2, i, np.float32)], pts=i))
        pipe["src"].end_stream()
        assert pipe.wait_eos(30)
        pipe.stop()
        assert [b.pts for b in pipe["out"].buffers] == [0, 1, 2]
        negotiated.append(str(pipe["out"].sinkpad.caps))
    assert negotiated[0] == negotiated[1]


def _stale_library(monkeypatch, tmp_path):
    """Point the port's ring bindings at a library older than its source,
    with a rebuild that fails."""
    import os
    from nnstreamer_tpu_torch.native import lib
    so, src = tmp_path / "libnnstpu.so", tmp_path / "nns_ring.cc"
    so.write_bytes(b"")
    src.write_text("// newer than the library\n")
    os.utime(so, (1_000_000, 1_000_000))
    os.utime(src, (2_000_000, 2_000_000))
    monkeypatch.setattr(lib, "_LIB_PATH", str(so))
    monkeypatch.setattr(lib, "_SOURCES", (str(src),))
    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(lib, "_build_tried", False)
    monkeypatch.setattr(lib, "_try_build", lambda: False)
    return lib


def test_native_queue_backend_is_refused(monkeypatch, tmp_path):
    """queue backend=native over a stale library whose rebuild failed is
    refused at parse, and never falls back to the Python queue."""
    _stale_library(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="make native"):
        pt.parse_launch("tensortestsrc caps=other/tensors,format=static,"
                        "num_tensors=1,types=uint8,dimensions=4,"
                        "framerate=0/1 ! queue backend=native ! fakesink")


def test_stale_native_library_is_not_loaded(monkeypatch, tmp_path, caplog):
    lib = _stale_library(monkeypatch, tmp_path)
    with caplog.at_level("WARNING"):
        assert lib.load_native_lib() is None
    assert "older than its sources" in caplog.text
    assert lib.native_built()  # on disk, but not loaded
