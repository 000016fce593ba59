"""Mesh mode in the port's *pipeline* layer against the JAX package's, on
the CPU.

Mirrors tests/test_mesh_filter.py: a ``tensor_filter custom=mesh:...``
invoke fanned out over the mesh (weights placed by the rule table, the
batch split over ``data``), the query fan-out and micro-batch servers,
the fused segment's mesh branch, the in-flight window's per-mesh slot;
then the serve line with ``tensor_serve_src mesh=`` and the trainer with
``mesh=``/``rules=``. The port runs on an 8-rank gloo world (one per
file, held by the module fixture), the JAX package on conftest.py's 8
virtual CPU devices.

The port's models carry the JAX zoo models' weights (``.py`` model files
that load the JAX seed-0 params through ``models.convert``), so every
line is compared three ways: the port's mesh run against the port's own
one-rank run — bitwise where the JAX test asks bytes, else at the JAX
test's tolerance — and the port's one-rank run against the JAX
package's within 1e-6 (f32 sums in another order).

Every port line here opens with ``accelerator=true:cpu``: a mesh runs
on the card unless the caller opts out, as a per-card filter does.

The batch is split over ``data`` as the JAX package splits it, one row
a rank included. A one-row block runs the BLAS's matrix-vector kernel,
which sums in another order than the one-rank matrix product, so such a
batch is held to 1e-6, not to bytes (the JAX package's batch-8 ``mlp``
over ``mesh:8x1x1`` differs from its one-device invoke by 7.2e-7, which
is why its ``test_mesh_filter_window_reports_mesh_devices`` fails); two
rows a rank or more give the one-rank bytes.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.filters import FilterProperties as JProps
from nnstreamer_tpu.filters import find_filter as j_find_filter
from nnstreamer_tpu_torch.filters import FilterProperties, find_filter
from nnstreamer_tpu_torch.filters.base import Accelerator
from nnstreamer_tpu_torch.parallel import world
from nnstreamer_tpu_torch.parallel.mesh import set_host_devices
from nnstreamer_tpu_torch.parallel.sharding import batch_sharding

CAPS8x64 = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)64:8,framerate=0/1")
CAPS8x8 = ("other/tensors,format=static,num_tensors=1,"
           "types=(string)float32,dimensions=(string)8:8,framerate=0/1")
JAX_TOL = dict(rtol=1e-6, atol=1e-6)

_MODEL_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models import convert, zoo


def get_model():
    """The port's zoo://{name} with the JAX zoo model's seed-0 weights."""
    apply_fn, module, in_info, out_info = zoo.build("{name}", **{kwargs!r})
    tree = dict(np.load({npz!r}))
    module.load_state_dict(convert.{conv}(tree))
    return apply_fn, module, in_info, out_info
'''


@pytest.fixture(scope="module", autouse=True)
def mesh_world():
    """One 8-rank world for the whole file."""
    set_host_devices(8)
    world.retain()
    yield world.world()
    world.shutdown()
    set_host_devices(None)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{zoo name: .py model file of the port with the JAX weights}."""
    from nnstreamer_tpu.models import zoo as jzoo
    d = tmp_path_factory.mktemp("mesh-models")
    out = {}
    for name, kwargs, conv in (
            ("mlp", {"dtype": "float32"}, "mlp_params_from_jax"),
            ("toyseg", {}, "toy_params_from_jax"),
            ("toyscale", {}, "toy_params_from_jax")):
        _, params, _, _ = jzoo.build(name, **kwargs)
        npz = str(d / f"{name}.npz")
        np.savez(npz, **{k: np.asarray(v) for k, v in params.items()})
        py = d / f"{name}.py"
        py.write_text(_MODEL_PY.format(name=name, kwargs=kwargs, npz=npz,
                                       conv=conv))
        out[name] = str(py)
    return out


JAX_URI = {"mlp": "zoo://mlp?dtype=float32", "toyseg": "zoo://toyseg",
           "toyscale": "zoo://toyscale"}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _open(model, custom=""):
    fw = find_filter("torch-cuda")()
    fw.open(FilterProperties(framework="torch-cuda", model_files=(model,),
                             custom_properties=custom,
                             accelerators=(Accelerator.CPU,)))
    return fw


def _one_rank(model, xs):
    fw = _open(model)
    out = [fw.invoke([torch.from_numpy(x)])[0].numpy() for x in xs]
    fw.close()
    return out


def _jax(name, xs):
    fw = j_find_filter("jax")()
    fw.open(JProps(framework="jax", model_files=(JAX_URI[name],)))
    out = [np.asarray(fw.invoke([x])[0]) for x in xs]
    fw.close()
    return out


def _followers_ran(before, n=8):
    after = world.world().executed
    return all(a > b for a, b in zip(after[1:n], before[1:n]))


def test_mesh_invoke_matches_single_device(models):
    x = np.random.RandomState(0).randn(8, 64).astype(np.float32)
    want = _one_rank(models["mlp"], [x])[0]
    np.testing.assert_allclose(want, _jax("mlp", [x])[0], **JAX_TOL)
    fw = _open(models["mlp"], "mesh:4x1x2,rules:gpt")
    before = list(world.world().executed)
    out = fw.invoke([torch.from_numpy(x)])[0]
    # the invoke really fanned out: every rank of the 8 ran it
    assert fw.mesh.mesh.numel() == 8 and _followers_ran(before)
    # Megatron TP over model sums w2's partial products in another order
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    fw.close()


def test_mesh_invoke_indivisible_batch_replicates(models):
    x = np.random.RandomState(1).randn(3, 64).astype(np.float32)
    fw = _open(models["mlp"], "mesh:4x1x2,rules:gpt")
    out = fw.invoke([torch.from_numpy(x)])[0].numpy()
    assert out.shape == (3, 10)
    np.testing.assert_allclose(out, _one_rank(models["mlp"], [x])[0],
                               rtol=1e-5, atol=1e-5)
    fw.close()


def test_mesh_suspend_resume_keeps_sharding(models):
    from nnstreamer_tpu_torch.filters.base import FilterEvent
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 64)
                         .astype(np.float32))
    fw = _open(models["mlp"], "mesh:4x1x2,rules:gpt")
    want = fw.invoke([x])[0]
    assert fw.handle_event(FilterEvent.SUSPEND)
    before = list(world.world().executed)
    got = fw.invoke([x])[0]  # transparent resume, still on the mesh
    assert fw.mesh.mesh.numel() == 8 and _followers_ran(before)
    from torch.distributed.tensor import DTensor
    assert isinstance(fw.mesh_model.module.w1, DTensor)
    assert torch.equal(got, want)
    fw.close()


def _pipe_run(pkg, fw_part, x):
    p = pkg.parse_launch(
        f'appsrc name=in caps="{CAPS8x64}" ! tensor_filter {fw_part} '
        "! appsink name=out")
    p.start()
    p["in"].push_buffer(pkg.Buffer.from_arrays([x]))
    p["in"].end_stream()
    assert p.wait_eos(timeout=60)
    p.stop()
    return np.asarray(p["out"].buffers[-1].chunks[0].host())


def test_pipeline_mesh_filter_matches_single_device(models):
    """A *pipeline* on the 8-rank mesh whose sharded invoke output equals
    the one-rank output (1e-5, the JAX test's), which is JAX's (1e-6)."""
    x = np.random.RandomState(3).randn(8, 64).astype(np.float32)
    single = _pipe_run(pt, "framework=torch-cuda accelerator=true:cpu "
                       f"model={models['mlp']}", x)
    meshed = _pipe_run(pt, "framework=torch-cuda accelerator=true:cpu "
                       f"model={models['mlp']} custom=mesh:2x1x4,rules:gpt",
                       x)
    np.testing.assert_allclose(meshed, single, rtol=1e-5, atol=1e-5)
    jax_single = _pipe_run(nt, "framework=jax model=zoo://mlp?dtype=float32",
                           x)
    np.testing.assert_allclose(single, jax_single, **JAX_TOL)


def _client_round(port, xs, name):
    results = {}

    def run_client(tag):
        c = pt.parse_launch(
            f'appsrc name=in caps="{CAPS8x64}" '
            f"! tensor_query_client port={port} timeout=20 "
            "! appsink name=out")
        c.start()
        c["in"].push_buffer(pt.Buffer.from_arrays([xs[tag]]))
        deadline = time.monotonic() + 30
        while not c["out"].buffers and time.monotonic() < deadline:
            time.sleep(0.05)
        results[tag] = [np.asarray(b.chunks[0].host()).copy()
                        for b in c["out"].buffers]
        c["in"].end_stream()
        c.stop()

    threads = [threading.Thread(target=run_client, args=(i,)) for i in xs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=45)
    return results


def test_query_fanout_to_mesh_server(models):
    """BASELINE config 5 shape: several query clients feed one server
    whose filter holds ONE mesh-placed model (batch over data)."""
    port = _free_port()
    server = pt.parse_launch(
        f"tensor_query_serversrc name=qs port={port} id=7 "
        f"! tensor_filter framework=torch-cuda accelerator=true:cpu "
        f"model={models['mlp']} custom=mesh:4x1x2,rules:gpt "
        "! tensor_query_serversink id=7")
    server.start()
    time.sleep(0.2)
    xs = {i: np.random.RandomState(10 + i).randn(8, 64).astype(np.float32)
          for i in range(2)}
    want = dict(zip(xs, _one_rank(models["mlp"], list(xs.values()))))
    jwant = dict(zip(xs, _jax("mlp", list(xs.values()))))
    results = _client_round(port, xs, "fanout")
    server.stop()
    for i in xs:
        assert len(results[i]) == 1, f"client {i} got {results[i]}"
        np.testing.assert_allclose(results[i][0], want[i],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(results[i][0], jwant[i],
                                   rtol=1e-4, atol=1e-4)


def test_query_microbatch_lands_sharded_on_mesh(models):
    """serversrc batch>1 stacks frames from several requests into ONE
    invoke whose batch dim rides the mesh's data axis."""
    port = _free_port()
    server = pt.parse_launch(
        f"tensor_query_serversrc name=qs port={port} id=8 batch=4 "
        "! tensor_filter name=f framework=torch-cuda accelerator=true:cpu "
        f"model={models['mlp']} "
        'custom="mesh:4x1x2,rules:gpt" ! tensor_query_serversink id=8')
    server.start()
    time.sleep(0.2)
    n_frames = 6
    xs = [np.random.RandomState(30 + i).randn(8, 64).astype(np.float32)
          for i in range(n_frames)]
    want = _one_rank(models["mlp"], xs)
    c = pt.parse_launch(
        f'appsrc name=in caps="{CAPS8x64}" '
        f"! tensor_query_client port={port} timeout=20 max-request=8 "
        "! appsink name=out")
    c.start()
    for x in xs:
        c["in"].push_buffer(pt.Buffer.from_arrays([x]))
    deadline = time.monotonic() + 40
    while len(c["out"].buffers) < n_frames and time.monotonic() < deadline:
        time.sleep(0.05)
    c["in"].end_stream()
    n_invokes = server["f"]._invoke_count
    sigs = set(server["f"].fw._mesh_sigs)
    c.stop()
    server.stop()
    out = c["out"].buffers
    assert len(out) == n_frames
    for i, b in enumerate(out):
        np.testing.assert_allclose(b.chunks[0].host(), want[i],
                                   rtol=1e-4, atol=1e-4)
    assert n_invokes < n_frames, (n_invokes, n_frames)
    assert any(sig[0][0] == (4, 8, 64) for sig in sigs), sigs


def test_filter_slices_padded_rows_of_host_outputs():
    """batch_valid_rows: padded micro-batch rows of HOST outputs are
    dropped before they hit the wire."""
    from nnstreamer_tpu_torch.pipeline.registry import make_element
    from nnstreamer_tpu_torch.tensors.buffer import Buffer as B, Chunk
    f = make_element("tensor_filter", framework="torch-cuda",
                     accelerator="true:cpu", model="zoo://mlp?dtype=float32")
    got = []
    f.start()

    class HostFw:
        def invoke(self, inputs):
            return [np.ones((4, 10), np.float32)]

    fw, f.fw = f.fw, HostFw()
    f.srcpad.push = got.append  # capture without a downstream element
    x = np.random.RandomState(0).randn(4, 8, 64).astype(np.float32)
    buf = B([Chunk(x)])
    buf.extras["batch_valid_rows"] = 2
    buf.extras["batch_rows"] = [(0, 0, None), (1, 0, None)]
    f.do_chain(f.sinkpad, buf)
    f.fw = fw
    f.stop()
    assert len(got) == 1
    assert got[0].chunks[0].shape[0] == 2  # padded rows 2..3 never ship


def _sink_bytes(p, sink="out"):
    out = []
    for buf in p[sink].buffers:
        out.append(tuple(
            (str(np.asarray(c.host()).dtype), np.asarray(c.host()).shape,
             np.ascontiguousarray(c.host()).tobytes())
            for c in buf.chunks))
    return out


@pytest.mark.parametrize("name,shape", [
    ("mlp", (64, 64)),
    ("toyseg", (64, 8, 8)),
])
def test_batch64_sharded_invoke_byte_identical(models, name, shape):
    """The serve path's parity contract: a batch-64 invoke laid out
    batch-major over the 8-rank mesh (8 rows a rank) is byte-identical
    to the one-rank invoke."""
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    want = _one_rank(models[name], [x])[0]
    np.testing.assert_allclose(want, _jax(name, [x])[0], **JAX_TOL)
    fw = _open(models[name], "mesh:8x1x1")
    before = list(world.world().executed)
    out = fw.invoke([torch.from_numpy(x)])[0].numpy()
    assert _followers_ran(before)
    assert out.tobytes() == want.tobytes()
    fw.close()


def test_fused_segment_on_mesh_byte_identical(models):
    """A fused run of two mesh members stays on the mesh across the
    member boundary (one command a frame) and is byte-identical to the
    one-rank fused run and to the unfused chain."""
    desc = ("tensortestsrc num-buffers=4 caps={caps} ! "
            "tensor_filter framework=torch-cuda accelerator=true:cpu "
            "model={m1} {c} name=f1 ! tensor_filter framework=torch-cuda "
            "accelerator=true:cpu model={m2} {c} name=f2 ! appsink name=out")

    def run(custom, fuse):
        p = pt.parse_launch(desc.format(
            caps=CAPS8x8, m1=models["toyseg"], m2=models["toyscale"],
            c=f"custom={custom}" if custom else ""))
        p.fuse = fuse
        p.run(timeout=120)
        return p

    def segs(p):
        return [e for e in p.elements.values()
                if getattr(e, "IS_FUSED_SEGMENT", False)]

    plain = run("", fuse=False)
    fused = run("", fuse=True)
    before = list(world.world().executed)
    meshed = run("mesh:8x1x1", fuse=True)
    assert _followers_ran(before)
    sg = segs(meshed)
    assert len(sg) == 1, "mesh members did not fuse"
    assert sg[0].stats["fused_elements"] == 2
    assert sg[0].stats["devices"] == 8
    assert not segs(plain)
    a, b, c = _sink_bytes(plain), _sink_bytes(fused), _sink_bytes(meshed)
    assert len(a) == len(b) == len(c) == 4
    assert a == b == c, "sharded fused run is not byte-identical"
    jp = nt.parse_launch(
        f"tensortestsrc num-buffers=4 caps={CAPS8x8} ! tensor_filter "
        "framework=jax model=zoo://toyseg name=f1 ! tensor_filter "
        "framework=jax model=zoo://toyscale name=f2 ! appsink name=out")
    jp.fuse = True
    jp.run(timeout=120)
    for got, want in zip(c, _sink_bytes(jp)):
        g = np.frombuffer(got[0][2], np.float32)
        w = np.frombuffer(want[0][2], np.float32)
        np.testing.assert_allclose(g, w, **JAX_TOL)


def test_mesh_spec_change_breaks_fused_run(models):
    """One fused program runs on one mesh: members declaring different
    mesh specs do not share a segment."""
    p = pt.parse_launch(
        f"tensortestsrc num-buffers=2 caps={CAPS8x8} ! "
        "tensor_filter framework=torch-cuda accelerator=true:cpu "
        f"model={models['toyseg']} custom=mesh:8x1x1 name=f1 ! "
        "tensor_filter framework=torch-cuda accelerator=true:cpu "
        f"model={models['toyscale']} name=f2 ! appsink name=out")
    p.fuse = True
    p.run(timeout=120)
    assert not [e for e in p.elements.values()
                if getattr(e, "IS_FUSED_SEGMENT", False)]
    assert "mesh spec changes mid-run" in p._fusion_plan.vetoes["f2"]
    assert len(p["out"].buffers) == 2


def test_sharded_dispatch_occupies_one_window_slot():
    """The in-flight window budgets per MESH: one dispatched sharded
    batch takes one slot (one command), not one a rank."""
    from nnstreamer_tpu_torch.tensors.transfer import InFlightWindow
    w = InFlightWindow(2, devices=8)
    t1 = w.acquire()
    t2 = w.acquire()
    assert t1 is not None and t2 is not None
    assert w.acquire(timeout=0.05) is None
    rep = w.report()
    assert rep["window"] == 2
    assert rep["devices"] == 8
    assert rep["in_flight"] == 2
    w.release(t1)
    w.release(t2)
    assert w.idle()


@pytest.mark.parametrize("batch", [8, 16])
def test_mesh_filter_window_reports_mesh_devices(models, batch):
    """A windowed mesh filter's transfer_report carries the mesh's size,
    every frame settles through the window, and the batch is split over
    the 8 ranks as JAX splits it. Batch 16 (two rows a rank) gives the
    bytes of the one-rank invoke. Batch 8 leaves one row a rank, which
    runs the BLAS's matrix-vector kernel and sums in another order than
    the one-rank matrix product: within 1e-6 of it, as the JAX package's
    own version of this test is of its one-device invoke (7.2e-7 there,
    the reason that test fails on its bytes). Both within 1e-6 of
    JAX."""
    x = np.random.RandomState(11).randn(batch, 64).astype(np.float32)
    want = _one_rank(models["mlp"], [x])[0]
    np.testing.assert_allclose(want, _jax("mlp", [x])[0], **JAX_TOL)
    caps = CAPS8x64.replace("64:8", f"64:{batch}")
    p = pt.parse_launch(
        f'appsrc name=in caps="{caps}" '
        "! tensor_filter name=f framework=torch-cuda accelerator=true:cpu "
        f"model={models['mlp']} custom=mesh:8x1x1 in-flight=2 "
        "! appsink name=out")
    before = list(world.world().executed)
    p.start()
    for _ in range(4):
        p["in"].push_buffer(pt.Buffer.from_arrays([x]))
    p["in"].end_stream()
    assert p.wait_eos(timeout=120)
    rep = p["f"].transfer_report()
    placed = batch_sharding(p["f"].fw.mesh, x.ndim, batch)
    got = [np.frombuffer(g[0][2], np.float32).reshape(want.shape)
           for g in _sink_bytes(p)]
    p.stop()
    assert _followers_ran(before)
    assert placed[0] == Shard(0), f"the batch is not split: {placed}"
    assert rep["devices"] == 8
    assert rep["window"] == 2
    assert rep["completed"] == 4
    assert len(got) == 4
    for g in got:
        if batch == 16:
            assert g.tobytes() == want.tobytes()
        np.testing.assert_allclose(g, want, **JAX_TOL)


# ---------------------------------------------------- sharded serving

def test_serve_mesh_line_places_batches(models):
    """``tensor_serve_src mesh=4x1x1`` into a ``custom=mesh:4x1x1``
    filter: buckets snapped to the dp degree, every stacked batch placed
    on the mesh before dispatch (the filter passes it through), every
    request answered with the bytes of the unsharded serve line."""

    def serve(mesh):
        port = _free_port()
        src_mesh = f"mesh={mesh}" if mesh else ""
        filt = ("tensor_filter name=f framework=torch-cuda "
                f"accelerator=true:cpu model={models['mlp']} " +
                (f"custom=mesh:{mesh}" if mesh else ""))
        # 6 snaps up to 8 on the mesh; every bucket leaves 2 rows a rank
        # or more, so the bytes are the unsharded line's (module doc)
        buckets = "6,16" if mesh else "8,16"
        server = pt.parse_launch(
            f"tensor_serve_src name=src port={port} id=61 buckets={buckets} "
            f"max-wait-ms=20 {src_mesh} ! {filt} ! tensor_serve_sink id=61")
        server.start()
        caps = CAPS8x64.replace("64:8", "64")
        c = pt.parse_launch(
            f'appsrc name=in caps="{caps}" ! tensor_query_client '
            f"port={port} timeout=20 max-request=16 ! appsink name=out")
        c.start()
        rng = np.random.default_rng(5)
        frames = [rng.standard_normal(64).astype(np.float32)
                  for _ in range(12)]
        for i, f in enumerate(frames):
            c["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
        deadline = time.monotonic() + 60
        while len(c["out"].buffers) < len(frames) and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        got = {b.pts: np.asarray(b.chunks[0].host()).tobytes()
               for b in c["out"].buffers}
        rep = server["src"].scheduler.report()
        c["in"].end_stream()
        c.stop()
        server.stop()
        return got, rep

    plain, _ = serve("")
    meshed, rep = serve("4x1x1")
    assert len(meshed) == 12 and meshed == plain
    assert rep["buckets"] == [8, 16] and rep["devices"] == 4
    assert rep["placed_batches"] > 0
    assert rep["completed"] == 12


def test_mesh_opens_on_the_card_unless_the_caller_opts_out(models,
                                                           monkeypatch):
    """Without ``accelerator=true:cpu`` a mesh filter and a mesh trainer
    want the card, as a per-card open does: where CUDA is missing they
    raise, and the CPU world of this file is not joined."""
    from test_torch_training import MLP
    from nnstreamer_tpu_torch.trainers import (TrainerProperties,
                                               find_trainer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = list(world.world().executed)
    fw = find_filter("torch-cuda")()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fw.open(FilterProperties(framework="torch-cuda",
                                 model_files=(models["mlp"],),
                                 custom_properties="mesh:8x1x1"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        find_trainer("torch-cuda")().create(
            TrainerProperties(model_config=MLP, mesh="2x1x2"))
    assert world.world().executed == before
    assert world.world().users == 1  # the file's fixture alone


def test_trainer_mesh_matches_the_jax_trainer(tmp_path):
    """``tensor_trainer mesh=2x1x2 rules=gpt`` on the f32 mlp (w1
    column-, w2 row-sharded over model; the batch over data) from the
    JAX init: every [loss, acc, vloss, vacc] record within
    tests/test_torch_training.py's Adam tolerance of the JAX trainer on
    the same mesh, and of the port's one-rank trainer."""
    from test_torch_training import (MLP, _jax_init_path, _records,
                                     _trainer_line, _write_dataset)
    data, jpath, _, _ = _write_dataset(tmp_path)
    init = _jax_init_path(tmp_path, "mlp", in_dim="8", hidden="16",
                          out_dim="4", dtype="float32")
    lines = {
        "mesh": (pt, "torch-cuda accelerator=true:cpu mesh=2x1x2 rules=gpt "
                 f"model-load-path={init}"),
        "one": (pt, f"torch-cuda accelerator=true:cpu model-load-path={init}"),
        "jax": (nt, "jax mesh=2x1x2 rules=gpt"),
    }
    recs = {}
    for key, (pkg, fw) in lines.items():
        p = pkg.parse_launch(_trainer_line(data, jpath, MLP, fw, 6, 24, 8))
        p.run(timeout=300)
        recs[key] = _records(p)
    assert recs["mesh"].shape == (7, 4)
    np.testing.assert_allclose(recs["mesh"], recs["jax"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(recs["mesh"], recs["one"], rtol=1e-4,
                               atol=1e-5)
    assert world.started() and world.world().broken is None


def test_trainer_mesh_snapshot_resumes_the_same_step(tmp_path):
    """A mesh trainer's snapshot gathers whole weights and Adam moments
    on rank 0; a second mesh trainer resumed from it takes the next step
    with the loss of the first one's next step, to the bit."""
    from test_torch_training import MLP
    from nnstreamer_tpu_torch.trainers import (TrainerProperties,
                                               find_trainer)
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))]
    ys = [torch.from_numpy(np.eye(4, dtype=np.float32)[
        rng.integers(0, 4, 12)])]
    props = TrainerProperties(model_config=MLP, mesh="2x1x2", rules="gpt",
                              accelerators=(Accelerator.CPU,))
    first = find_trainer("torch-cuda")()
    first.create(props)
    first._step(xs, ys)
    first._step(xs, ys)
    blob = first.snapshot(str(tmp_path))
    want = first._step(xs, ys)
    second = find_trainer("torch-cuda")()
    second.create(props)
    try:
        second.resume_from(blob, str(tmp_path))
        got = second._step(xs, ys)
    finally:
        second.destroy()
        first.destroy()
    assert blob["opt_state"]["state"], "no Adam moments in the snapshot"
    assert got == want
    assert world.started()  # the file's fixture still holds the world


def test_simlink_auto_mesh_takes_the_pools_dp():
    """simlink's ``mesh:auto`` reads the data-parallel degree of the
    pool's best mesh, as JAX's reads its devices': 2 of 8 here."""
    from nnstreamer_tpu_torch.parallel.mesh import spec_dp
    from nnstreamer_tpu.parallel.mesh import spec_dp as j_spec_dp
    fw = find_filter("simlink")()
    fw.open(FilterProperties(framework="simlink",
                             custom_properties="mesh:auto,svc-row:1"))
    jfw = j_find_filter("simlink")()
    jfw.open(JProps(framework="simlink",
                    custom_properties="mesh:auto,svc-row:1"))
    assert fw._dp == jfw._dp == spec_dp("auto") == j_spec_dp("auto") == 2
    assert spec_dp("4x1x2") == 4 and spec_dp("") == 1
