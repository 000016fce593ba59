"""The rest of tensor_filter in the port against the JAX package's, on
the CPU: the shared-model key, suspend/resume and reload, input/output
combination (fused and unfused), invoke-dynamic, donate-input, host
inputs for numpy user functions, and a fused filter across a reload.

Both packages run the same launch line on the same seeded frames. The
JAX side names ``zoo://<model>``; the port's side a model file serving
that zoo model's own weights (converted through models/convert.py).
Tolerances: ``toyseg``/``toyscale`` (an f32 ``x * scale + shift`` a
stage) within ``TOY_ATOL``, the port's fused and unfused runs bitwise;
the bf16 ``mlp`` within ``MLP_ATOL``, the tolerance of
tests/test_torch_pipeline.py's mlp parity; tensors passed through and
index vectors bitwise.
"""
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.filters import registry as jax_registry
from nnstreamer_tpu.filters import register_custom_easy as jax_register
from nnstreamer_tpu.filters import unregister_custom_easy as jax_unregister
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu.utils.watchdog import Watchdog as JaxWatchdog
from nnstreamer_tpu_torch.filters import register_custom_easy, registry
from nnstreamer_tpu_torch.filters import unregister_custom_easy
from nnstreamer_tpu_torch.filters.torch_cuda_backend import DONATION_NOTE
from nnstreamer_tpu_torch.utils.watchdog import Watchdog

MLP_CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)float32,"
            "dimensions=(string)64,framerate=(fraction)0/1")
SEG_CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)float32,"
            "dimensions=(string)8:8,framerate=(fraction)0/1")
PAIR_CAPS = ("other/tensors,format=static,num_tensors=2,"
             "types=(string)\"uint8,float32\",dimensions=(string)\"4:4,8:8\","
             "framerate=(fraction)0/1")
# one bf16 ulp of an output in [1, 2), as tests/test_torch_pipeline.py
MLP_ATOL = 2.0 ** -7
# XLA:CPU contracts x * scale + shift into one fused multiply-add, torch
# rounds the product first: one f32 ulp of |x * scale| (< 2.4e-7 for the
# toy weights' magnitudes) a stage, scaled by the next stage's |scale|
TOY_ATOL = 4e-6
CPU = "accelerator=true:cpu"

MODEL_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models import convert, zoo


def get_model():
    apply_fn, module, in_info, out_info = zoo.build({name!r})
    flat = np.load({npz!r})
    module.load_state_dict(convert.{convert}(
        {{k: flat[k].astype(np.float32) for k in flat.files}}))
    return apply_fn, module, in_info, out_info
'''
CONVERT = {"mlp": "mlp_params_from_jax", "toyseg": "toy_params_from_jax",
           "toyscale": "toy_params_from_jax"}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """``models(name, seed)``: a port model file serving the JAX zoo
    model's weights (made once per name and seed; no seed: the zoo
    zoo model's default seed, as ``zoo://<name>`` has it)."""
    tmp = tmp_path_factory.mktemp("models")
    made = {}

    def make(name, seed=None):
        if (name, seed) not in made:
            kw = {} if seed is None else {"seed": seed}
            _, params, _, _ = jax_zoo.build(name, **kw)
            npz = tmp / f"{name}{seed}.npz"
            np.savez(npz, **{k: np.asarray(v, dtype=np.float32)
                             for k, v in params.items()})
            path = tmp / f"{name}{seed}.py"
            path.write_text(MODEL_PY.format(name=name, npz=str(npz),
                                            convert=CONVERT[name]))
            made[name, seed] = str(path)
        return made[name, seed]

    return make


def _run(pkg, line, fuse=True):
    pipe = pkg.parse_launch(line)
    pipe.fuse = fuse
    pipe.run(timeout=120)
    return pipe


def _outs(pipe, sink="out"):
    return [[np.asarray(c.host()) for c in b.chunks]
            for b in pipe[sink].buffers]


def _segments(pipe):
    return [e for e in pipe.elements.values()
            if getattr(e, "IS_FUSED_SEGMENT", False)]


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# -- the shared-model key ---------------------------------------------------

SHARED_LINE = ("tensortestsrc caps={caps} num-buffers=4 pattern=random "
               "seed=3 ! tee name=t "
               "t. ! queue ! tensor_filter name=a {fw} model={model} "
               "shared-tensor-filter-key=legs ! appsink name=oa "
               "t. ! queue ! tensor_filter name=b {fw} model={model} "
               "shared-tensor-filter-key=legs ! appsink name=ob")


def test_shared_key_two_legs_one_backend(models):
    """Two filters under one key share one opened backend (one executable
    for the signature); both legs equal the JAX pair within the mlp
    tolerance, and the last release closes the backend."""
    port = pt.parse_launch(SHARED_LINE.format(
        caps=MLP_CAPS, fw=f"framework=torch-cuda {CPU}",
        model=models("mlp")))
    jax = nt.parse_launch(SHARED_LINE.format(
        caps=MLP_CAPS, fw="framework=jax", model="zoo://mlp"))
    seen = {}
    for name, pipe in (("port", port), ("jax", jax)):
        pipe.start()
        try:
            assert pipe.wait_eos(120)
            fw = pipe["a"].fw
            assert fw is pipe["b"].fw
            seen[name] = (fw.compile_count, fw)
        finally:
            pipe.stop()
    assert seen["port"][0] == seen["jax"][0] == 1
    assert registry.shared_model_get("legs") is None
    assert jax_registry.shared_model_get("legs") is None
    assert seen["port"][1]._module is None  # closed at the last release
    for sink in ("oa", "ob"):
        got, want = _outs(port, sink), _outs(jax, sink)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[0], w[0], rtol=0, atol=MLP_ATOL)
    assert all(np.array_equal(a[0], b[0])
               for a, b in zip(_outs(port, "oa"), _outs(port, "ob")))


def test_shared_key_table_counts_as_jax():
    """get/insert/release keep the JAX table's reference counts; one
    release per holder, the last one closes."""
    class Fake:
        closed = 0

        def close(self):
            self.closed += 1

    trace = {}
    for name, reg in (("port", registry), ("jax", jax_registry)):
        first, second = Fake(), Fake()
        key = "table-counts"  # no other test opens a filter under it
        steps = [reg.shared_model_get(key) is None,
                 reg.shared_model_insert(key, first) is first,
                 reg.shared_model_insert(key, second) is first,
                 reg.shared_model_get(key) is first,
                 reg.shared_model_release(key),
                 reg.shared_model_release(key), first.closed,
                 reg.shared_model_release(key), first.closed,
                 second.closed, reg.shared_model_release(key)]
        trace[name] = steps
    assert trace["port"] == trace["jax"] == [
        True, True, True, True, False, False, 0, True, 1, 0, False]


def test_shared_backend_owns_its_graph_pool(models):
    """A shared backend is opened without the element's graph pool, so
    its graphs live until the last release, not until one filter stops;
    an unshared one captures into its element's pool."""
    pipe = pt.parse_launch(SHARED_LINE.format(
        caps=MLP_CAPS, fw=f"framework=torch-cuda {CPU}",
        model=models("mlp")))
    solo = pt.parse_launch(
        f"tensortestsrc caps={MLP_CAPS} num-buffers=1 ! tensor_filter "
        f"name=a framework=torch-cuda {CPU} model={models('mlp')} "
        "! appsink name=out")
    for p in (pipe, solo):
        p.start()
    try:
        assert pipe["a"].fw._own_pool
        assert solo["a"].fw._pool is solo["a"]._graph_pool
    finally:
        pipe.stop()
        solo.stop()


# -- suspend and reload -----------------------------------------------------

def _is_suspended(fw):
    return getattr(fw, "_suspended", None) or \
        getattr(fw, "_host_module", None) is not None


def _suspend_reload_run(pkg, line, x, reload_to):
    """Push x, wait for the idle suspend, push x (resumes), reload to
    ``reload_to``, push x; returns (outputs, compile counts after each
    frame)."""
    pipe = pkg.parse_launch(line)
    pipe.start()
    counts = []
    try:
        f = pipe["f"]
        n = 0
        for step in ("first", "resume", "reload"):
            if step == "reload":
                assert f.reload_model(reload_to)
            pipe["in"].push_buffer(pkg.Buffer.from_arrays([x], pts=n))
            n += 1
            _wait(lambda: len(pipe["out"].buffers) == n, f"frame {n}")
            counts.append(f.fw.compile_count)
            if step == "first":
                _wait(lambda: _is_suspended(f.fw), "the idle suspend")
                assert f.fw.compile_count == 1
        pipe["in"].end_stream()
        assert pipe.wait_eos(60)
    finally:
        pipe.stop()
    return [b.chunks[0].host() for b in pipe["out"].buffers], counts


def test_suspend_resume_and_reload_match_jax(models):
    """suspend=100 on the mlp line: the idle watchdog unloads the model,
    the next frame resumes it (one recompile) with the same output, and
    reload_model swaps in the seed-1 weights for the frames after it —
    in both packages, within the mlp tolerance."""
    x = np.random.default_rng(2).random(64).astype(np.float32)
    line = ('appsrc name=in caps="{caps}" ! tensor_filter name=f {fw} '
            "suspend=100 ! appsink name=out")
    got, got_counts = _suspend_reload_run(
        pt, line.format(caps=MLP_CAPS, fw=f"framework=torch-cuda {CPU} "
                        f"model={models('mlp')}"),
        x, models("mlp", "1"))
    want, want_counts = _suspend_reload_run(
        nt, line.format(caps=MLP_CAPS, fw="framework=jax model=zoo://mlp"),
        x, "zoo://mlp?seed=1")
    assert got_counts == want_counts == [1, 2, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=MLP_ATOL)
    assert np.array_equal(got[0], got[1])
    assert not np.allclose(got[0], got[2], atol=MLP_ATOL)


def test_suspend_keeps_a_copy_and_drops_the_executables(models):
    """SUSPEND leaves the module it took off the device untouched (a
    fused program may hold it), keeps a host copy and drops every
    executable; RESUME brings a copy back."""
    from nnstreamer_tpu_torch.filters.base import (Accelerator, FilterEvent,
                                                   FilterProperties)
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    fw = TorchCudaFilter()
    fw.open(FilterProperties(framework="torch-cuda",
                             model_files=(models("mlp"),),
                             accelerators=(Accelerator.CPU,)))
    x = np.ones(64, np.float32)
    before = fw.invoke([x])[0]
    fn = fw.traceable_fn()
    module = fw._module
    assert fw.handle_event(FilterEvent.SUSPEND)
    assert fw._module is None and not fw._executables
    assert fw._host_module is not module
    assert torch.equal(fn(torch.from_numpy(x)), before)
    assert fw.handle_event(FilterEvent.RESUME)
    assert fw._host_module is None and fw._module is not module
    assert torch.equal(fw.invoke([x])[0], before)
    assert fw.compile_count == 2
    fw.close()


def test_events_race_invokes_on_a_shared_backend(models):
    """Stress: eight threads invoke one backend (as filters under one
    shared key do) while another sends SUSPEND, RESUME and RELOAD_MODEL
    (seed 0 and seed 1 in turn), with a short switch interval. Every
    output is bitwise one model's, and nothing raises."""
    import sys
    from nnstreamer_tpu_torch.filters.base import (Accelerator, FilterEvent,
                                                   FilterProperties)
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    paths = [models("mlp"), models("mlp", "1")]
    x = np.random.default_rng(9).random(64).astype(np.float32)
    refs = []
    for path in paths:
        ref = TorchCudaFilter()
        ref.open(FilterProperties(model_files=(path,),
                                  accelerators=(Accelerator.CPU,)))
        refs.append(ref.invoke([x])[0])
        ref.close()
    assert not torch.equal(refs[0], refs[1])
    fw = TorchCudaFilter()
    fw.open(FilterProperties(model_files=(paths[0],),
                             accelerators=(Accelerator.CPU,)))
    errors, bad, stop = [], [], threading.Event()

    def invoke():
        try:
            while not stop.is_set():
                out = fw.invoke([x])[0]
                if not any(torch.equal(out, r) for r in refs):
                    bad.append(out)
        except Exception as exc:  # noqa: BLE001 -- the test's finding
            errors.append(exc)

    def events():
        try:
            for i in range(30):
                fw.handle_event(FilterEvent.SUSPEND)
                fw.handle_event(FilterEvent.RESUME)
                fw.handle_event(FilterEvent.RELOAD_MODEL,
                                {"model_files": (paths[(i + 1) % 2],)})
        except Exception as exc:  # noqa: BLE001 -- the test's finding
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=invoke) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        ev = threading.Thread(target=events)
        ev.start()
        ev.join(120)
        stop.set()
        for t in threads:
            t.join(60)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    assert not ev.is_alive() and not any(t.is_alive() for t in threads)
    assert not errors and not bad
    fw.close()


def test_fused_filter_serves_planned_weights_across_reload(models):
    """Reference behaviour: a filter fused with the element after it
    keeps serving the weights the segment was planned with after
    reload_model (the JAX backend's traceable_fn captures its params by
    value); unfused, the reload reaches the frames after it. Both
    packages within TOY_ATOL; the port's first frame fused and unfused
    bitwise."""
    line = ('appsrc name=in caps="{caps}" ! tensor_filter name=f {fw} '
            "model={seg} ! tensor_filter name=g {fw} model={scale} "
            "! appsink name=out")
    port = line.format(caps=SEG_CAPS, fw=f"framework=torch-cuda {CPU}",
                       seg=models("toyseg"), scale=models("toyscale"))
    jax = line.format(caps=SEG_CAPS, fw="framework=jax",
                      seg="zoo://toyseg", scale="zoo://toyscale")
    x = np.random.default_rng(4).random((8, 8)).astype(np.float32)
    runs = {}
    for name, pkg, desc, reload_to in (
            ("port", pt, port, models("toyseg", "5")),
            ("jax", nt, jax, "zoo://toyseg?seed=5")):
        for fuse in (True, False):
            pipe = pkg.parse_launch(desc)
            pipe.fuse = fuse
            pipe.start()
            try:
                assert len(_segments(pipe)) == int(fuse)
                pipe["in"].push_buffer(pkg.Buffer.from_arrays([x], pts=0))
                _wait(lambda: len(pipe["out"].buffers) == 1, "frame 0")
                assert pipe["f"].reload_model(reload_to)
                pipe["in"].push_buffer(pkg.Buffer.from_arrays([x], pts=1))
                pipe["in"].end_stream()
                assert pipe.wait_eos(60)
            finally:
                pipe.stop()
            runs[name, fuse] = [np.asarray(b.chunks[0].host())
                                for b in pipe["out"].buffers]
    for fuse in (True, False):
        for g, w in zip(runs["port", fuse], runs["jax", fuse]):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOY_ATOL)
    assert runs["port", True][0].tobytes() == \
        runs["port", False][0].tobytes()
    before, after = runs["port", True]
    assert np.array_equal(before, after)          # fused: planned weights
    before, after = runs["port", False]
    assert not np.array_equal(before, after)      # unfused: reloaded


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_warmup_arms_suspend_only_on_an_unfused_filter(models, fuse):
    """warmup=true feeds the suspend watchdog once, so an unfused filter
    idle after it suspends; a fused filter's watchdog stays unarmed: its
    chain never runs, and the segment's program keeps the weights on
    the device, so a suspend would free nothing there."""
    pipe = pt.parse_launch(
        f'appsrc name=in caps="{SEG_CAPS}" ! tensor_filter name=f '
        f"framework=torch-cuda {CPU} model={models('toyseg')} warmup=true "
        f"suspend=50 ! tensor_filter name=g framework=torch-cuda {CPU} "
        f"model={models('toyscale')} ! appsink name=out")
    pipe.fuse = fuse
    pipe.start()
    try:
        assert len(_segments(pipe)) == int(fuse)
        assert pipe["f"].fused_in == ("fused_f" if fuse else None)
        _wait(lambda: pipe["f"].fw.compile_count == 1, "the warmup invoke")
        time.sleep(0.3)                  # six suspend windows, no frame
        assert (pipe["f"].fw._host_module is not None) == (not fuse)
    finally:
        pipe.stop()


# -- input/output combination -----------------------------------------------

COMBI_LINE = ("tensortestsrc caps={caps} num-buffers=3 pattern=random "
              "seed=6 ! tensor_filter name=f {fw} model={seg} "
              "input-combination=1 {out} ! {tail}appsink name=out")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("out", ["", "output-combination=o0,i0"])
def test_combination_matches_jax(models, fused, out):
    """input-combination=1 hands the model the stream's second tensor;
    output-combination=o0,i0 ships the output and the first tensor
    passed through. With a second filter after it the two fuse into one
    segment in both packages (the planner's choice is the same). The
    passed-through tensor is bitwise the JAX line's, the outputs within
    TOY_ATOL."""
    tail = "tensor_filter name=g {fw} model={scale} ! " if not out else ""
    line = COMBI_LINE.replace("{tail}", tail)
    port = line.format(caps=PAIR_CAPS, fw=f"framework=torch-cuda {CPU}",
                       seg=models("toyseg"), scale=models("toyscale"),
                       out=out)
    jax = line.format(caps=PAIR_CAPS, fw="framework=jax",
                      seg="zoo://toyseg", scale="zoo://toyscale", out=out)
    got, want = _run(pt, port, fused), _run(nt, jax, fused)
    assert len(_segments(got)) == len(_segments(want)) == \
        int(fused and not out)
    g, w = _outs(got), _outs(want)
    assert len(g) == len(w) == 3
    for a, b in zip(g, w):
        assert [(x.dtype, x.shape) for x in a] == \
            [(x.dtype, x.shape) for x in b]
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=TOY_ATOL)
        if out:
            assert a[1].tobytes() == b[1].tobytes()
    if out:
        assert [x.shape for x in g[0]] == [(8, 8, 5), (4, 4)]


def test_output_combination_caps_list_the_combined_tensors(models):
    """Reference fault: the JAX filter's src caps list the model's
    outputs whatever output-combination ships (its on_sink_caps never
    combines); the port's caps describe the buffers (≙ the reference C
    filter's combined out info). Same buffers in both."""
    line = ("tensortestsrc caps={caps} num-buffers=1 ! tensor_filter {fw} "
            "model={seg} input-combination=1 output-combination=i0,o0 "
            "! appsink name=out")
    got = _run(pt, line.format(caps=PAIR_CAPS, seg=models("toyseg"),
                               fw=f"framework=torch-cuda {CPU}"))
    want = _run(nt, line.format(caps=PAIR_CAPS, seg="zoo://toyseg",
                                fw="framework=jax"))
    gcfg = got["out"].sinkpad.caps.to_config()
    wcfg = want["out"].sinkpad.caps.to_config()
    # the JAX caps: the model's one output info; the port's: the
    # passed-through tensor's, then that output info
    assert [str(i.type) for i in wcfg.info] == ["float32"]
    assert [(str(i.type), i.shape) for i in gcfg.info] == \
        [("uint8", (4, 4)), ("float32", wcfg.info[0].shape)]
    assert [c.shape for c in got["out"].buffers[0].chunks] == \
        [c.shape for c in want["out"].buffers[0].chunks] == \
        [(4, 4), (8, 8, 5)]


# -- invoke-dynamic -----------------------------------------------------------

def _above_mean(x):
    """Indices of the entries above the frame's mean: one variable-length
    int32 vector a frame."""
    x = np.asarray(x)
    return np.nonzero(x > x.mean())[0].astype(np.int32)


def test_invoke_dynamic_flexible_caps_in_both(models):
    """invoke-dynamic=true: FLEXIBLE out caps and per-frame output
    shapes in both packages, the same indices as numpy's on the JAX
    line's logits; the filter is not fused."""
    register_custom_easy("above_mean", _above_mean)
    jax_register("above_mean", _above_mean)
    line = ("tensortestsrc caps={caps} num-buffers=4 pattern=random seed=7 "
            "! tensor_filter name=m {fw} model={mlp} ! tensor_filter name=d "
            "framework=custom-easy model=above_mean invoke-dynamic=true "
            "! appsink name=out")
    try:
        got = _run(pt, line.format(caps=MLP_CAPS, mlp=models("mlp"),
                                   fw=f"framework=torch-cuda {CPU}"))
        want = _run(nt, line.format(caps=MLP_CAPS, mlp="zoo://mlp",
                                    fw="framework=jax"))
        logits = _run(nt, line.split(" ! tensor_filter name=d")[0].format(
            caps=MLP_CAPS, mlp="zoo://mlp", fw="framework=jax")
            + " ! appsink name=out")
    finally:
        unregister_custom_easy("above_mean")
        jax_unregister("above_mean")
    for pipe in (got, want):
        assert pipe["out"].sinkpad.caps.to_config().format.name == "FLEXIBLE"
        assert not _segments(pipe)
    want_idx = [_above_mean(o[0]) for o in _outs(logits)]
    got_idx = [o[0] for o in _outs(got)]
    assert len({len(i) for i in got_idx}) > 1  # the shapes vary
    assert [i.tolist() for i in got_idx] == [i.tolist() for i in want_idx]
    assert [o[0].tolist() for o in _outs(want)] == \
        [i.tolist() for i in want_idx]


# -- donate-input --------------------------------------------------------------

def test_donate_input_outputs_unchanged_and_inputs_intact(models, caplog):
    """donate-input=true under in-flight=2: the outputs equal a run
    without it, every tensor pushed from upstream is bitwise intact after
    its frame, and the backend says once why it had nothing to donate."""
    frames = [torch.from_numpy(np.random.default_rng(i).random(64)
                               .astype(np.float32)) for i in range(6)]
    kept = [f.clone() for f in frames]
    line = (f'appsrc name=in caps="{MLP_CAPS}" ! tensor_filter name=f '
            f"framework=torch-cuda {CPU} model={models('mlp')} "
            "in-flight=2 {donate} ! appsink name=out")
    outs = {}
    caplog.set_level("INFO", logger="nnstreamer_tpu_torch")
    for donate in ("donate-input=true", ""):
        pipe = pt.parse_launch(line.format(donate=donate))
        pipe.start()
        try:
            for i, f in enumerate(frames):
                pipe["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
            pipe["in"].end_stream()
            assert pipe.wait_eos(60)
        finally:
            pipe.stop()
        outs[donate] = [b.chunks[0].host() for b in pipe["out"].buffers]
    assert all(torch.equal(f, k) for f, k in zip(frames, kept))
    assert len(outs[""]) == 6 and all(
        np.array_equal(a, b) for a, b in zip(outs["donate-input=true"],
                                             outs[""]))
    notes = [r for r in caplog.records if DONATION_NOTE in r.getMessage()]
    assert len(notes) == 1


# -- host inputs for numpy user functions ------------------------------------

def test_numpy_user_function_after_a_device_filter(models):
    """A custom-easy function that reads only numpy arrays, after a
    torch-cuda filter whose outputs are tensors: the element hands it
    host ndarrays, and its outputs equal the JAX line's within the mlp
    tolerance."""
    types = []

    def numpy_only(x):
        types.append(type(x))
        assert isinstance(x, np.ndarray), type(x)
        return np.tanh(x * 2).astype(np.float32)

    register_custom_easy("numpy_only", numpy_only)
    jax_register("numpy_only", lambda x: np.tanh(np.asarray(x) * 2)
                 .astype(np.float32))
    line = ("tensortestsrc caps={caps} num-buffers=3 pattern=random seed=8 "
            "! tensor_filter {fw} model={mlp} ! tensor_filter "
            "framework=custom-easy model=numpy_only ! appsink name=out")
    try:
        got = _run(pt, line.format(caps=MLP_CAPS, mlp=models("mlp"),
                                   fw=f"framework=torch-cuda {CPU}"))
        want = _run(nt, line.format(caps=MLP_CAPS, mlp="zoo://mlp",
                                    fw="framework=jax"))
    finally:
        unregister_custom_easy("numpy_only")
        jax_unregister("numpy_only")
    assert types == [np.ndarray] * 3
    for g, w in zip(_outs(got), _outs(want)):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=2 * MLP_ATOL)


def test_invoke_async_refused_at_start():
    """invoke-async is ported with the llm backend (tests/test_torch_llm.py);
    on a backend without the async output path start refuses it."""
    pipe = pt.parse_launch(
        f"tensortestsrc caps={MLP_CAPS} num-buffers=1 ! tensor_filter "
        f"framework=torch-cuda {CPU} model=zoo://mlp invoke-async=true "
        "! appsink")
    with pytest.raises(ValueError, match="invoke-async"):
        pipe.start()


# -- the watchdog ---------------------------------------------------------------

@pytest.mark.parametrize("cls", [Watchdog, JaxWatchdog],
                         ids=["port", "jax"])
def test_watchdog_fires_once_per_feed_and_never_after_destroy(cls):
    fired = threading.Event()
    count = []

    def bite():
        count.append(1)
        fired.set()

    dog = cls(0.05, bite)
    dog.feed()
    assert fired.wait(5)
    time.sleep(0.15)
    assert len(count) == 1           # fires once, then disarmed
    dog.feed()
    _wait(lambda: len(count) == 2, "the bite after a second feed", 5)
    dog.destroy()
    dog.feed()
    time.sleep(0.15)
    assert len(count) == 2
