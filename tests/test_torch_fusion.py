"""The port's fusion compiler (fusion/) against the JAX package's, on the
CPU.

Mirrors tests/test_fusion.py: planner boundaries, the ``fuse=false``
opt-out, byte parity of fused and unfused runs, the executable cache
(``jit_misses``/``jit_hits``), the default fault policy and the
lifecycle. Plan parity: each launch line planned by both packages gives
the same segments (member names) and the same veto keys. The filter !
decoder chain runs the JAX zoo's ``toyseg`` weights in both packages
(converted through models/convert.py), and its RGBA bytes equal the JAX
package's fused line and the port's unfused run, exactly.

The multi-pad boundaries (tensor_mux, tensor_crop, tee) are planned
and run here too; the tracer's fusion block is held against the JAX
package's in tests/test_torch_trace.py. The segment's on-error
policies and circuit breaker are held against the JAX package in
tests/test_torch_fault.py (``TestSegmentFaults``), pipelint's fusion
rules in tests/test_torch_analysis.py (``TestLintRules``).
"""
import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.fusion import plan_fusion as jax_plan_fusion
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu_torch.fusion import plan_fusion
from nnstreamer_tpu_torch.pipeline.element import TransformElement
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.pipeline.registry import make_element

CAPS_F32 = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)3:4:4,"
            "framerate=(fraction)0/1")
CAPS_U8 = ("other/tensors,format=static,num_tensors=1,"
           "types=(string)uint8,dimensions=(string)3:4:4,"
           "framerate=(fraction)0/1")
CAPS_SEG = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)8:8,"
            "framerate=(fraction)0/1")
CAPS_PAIR = ("other/tensors,format=static,num_tensors=2,"
             "types=(string)\"uint8,float32\",dimensions=(string)\"4:4,8:8\","
             "framerate=(fraction)0/1")
CAPS_F64 = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float64,dimensions=(string)3:4:4,"
            "framerate=(fraction)0/1")

# a fusible two-transform run used by several planner tests
RUN2 = ("tensor_transform name=a mode=arithmetic option=mul:2 ! "
        "tensor_transform name=b mode=transpose option=1:0:2")

PORT_FILTER = "framework=torch-cuda accelerator=true:cpu"


def _segments_of(p):
    return [e for e in p.elements.values()
            if getattr(e, "IS_FUSED_SEGMENT", False)]


def _run(desc, fuse=True, pkg=pt, timeout=60):
    p = pkg.parse_launch(desc)
    p.fuse = fuse
    p.run(timeout=timeout)
    return p


def _frames(p, sink="out"):
    """appsink contents as comparable (dtype, shape, bytes) tuples."""
    out = []
    for buf in p[sink].pop_all():
        out.append(tuple(
            (str(np.asarray(c.host()).dtype), np.asarray(c.host()).shape,
             np.ascontiguousarray(c.host()).tobytes())
            for c in buf.chunks))
    return out


def assert_parity(desc, sink="out", min_frames=1, jax_desc=None):
    """Fused and unfused runs of ``desc`` in the port are byte-identical,
    and equal the JAX package's fused run of ``jax_desc`` (default: the
    same description)."""
    fused = _run(desc, fuse=True)
    plain = _run(desc, fuse=False)
    ref = _run(jax_desc or desc, fuse=True, pkg=nt)
    assert not _segments_of(plain)
    a, b, c = _frames(fused, sink), _frames(plain, sink), _frames(ref, sink)
    assert len(a) == len(b) == len(c) >= min_frames
    assert a == b, "fused output is not byte-identical to the chain path"
    assert a == c, "fused output is not byte-identical to the JAX line"
    return fused


def _plans(desc, jax_desc=None):
    ours = plan_fusion(pt.parse_launch(desc))
    theirs = jax_plan_fusion(nt.parse_launch(jax_desc or desc))
    return ours, theirs


def _same_plan(ours, theirs):
    assert [s.names for s in ours.segments] == \
        [s.names for s in theirs.segments]
    assert set(ours.vetoes) == set(theirs.vetoes)


class TestPlannerBoundaries:
    def test_transform_run_fuses_sources_and_sinks_break(self):
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc name=src caps={CAPS_F32} ! {RUN2} ! "
            "appsink name=out"))
        assert [s.names for s in plan.segments] == [["a", "b"]]
        assert "source" in plan.vetoes["src"]
        assert "sink" in plan.vetoes["out"]

    def test_queue_is_a_thread_boundary(self):
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc caps={CAPS_F32} ! tensor_transform name=a "
            "mode=arithmetic option=mul:2 ! queue name=q ! "
            "tensor_transform name=b mode=arithmetic option=add:1 ! "
            "appsink name=out"))
        assert plan.segments == []
        assert "thread boundary" in plan.vetoes["q"]
        assert "run of 1" in plan.vetoes["a"]

    def test_run_of_one_is_left_on_the_chain_path(self):
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc caps={CAPS_F32} ! tensor_transform name=a "
            "mode=arithmetic option=mul:2 ! appsink name=out"))
        assert plan.segments == []
        assert "run of 1" in plan.vetoes["a"]

    def test_elements_without_device_fn_break_runs(self):
        # tensor_debug stands in for the JAX test's identity (not ported)
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc caps={CAPS_F32} ! tensor_transform name=a "
            "mode=arithmetic option=mul:2 ! tensor_debug name=i ! "
            "tensor_transform name=b mode=arithmetic option=add:1 ! "
            "appsink name=out"))
        assert plan.segments == []
        assert "no device function" in plan.vetoes["i"]

    def test_64bit_dtype_is_a_caps_boundary(self):
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc caps={CAPS_F64} ! {RUN2} ! appsink name=out"))
        assert plan.segments == []
        assert "x64" in plan.vetoes["a"]

    def test_invoke_dynamic_filter_declines(self):
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc caps={CAPS_SEG} ! tensor_filter name=f "
            f"{PORT_FILTER} model=zoo://toyseg invoke-dynamic=true ! "
            "tensor_decoder name=d mode=image_segment ! appsink name=out"))
        assert plan.segments == []
        assert "invoke-dynamic" in plan.vetoes["f"]

    def test_host_only_decoder_mode_declines(self):
        # image_labeling stands in for direct_video (not ported)
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc caps={CAPS_F32} ! tensor_transform name=a "
            "mode=arithmetic option=mul:2 ! tensor_decoder name=d "
            "mode=image_labeling ! appsink name=out"))
        assert plan.segments == []
        assert "host-only" in plan.vetoes["d"]

    def test_stand_mode_is_vetoed_for_parity(self):
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc caps={CAPS_F32} ! tensor_transform name=a "
            "mode=arithmetic option=mul:2 ! tensor_transform name=s "
            "mode=stand option=default ! appsink name=out"))
        assert plan.segments == []
        assert "byte-stable" in plan.vetoes["s"]

    def test_multi_pad_elements_are_structural_boundaries(self):
        plan = plan_fusion(pt.parse_launch(
            "tensor_mux name=m ! appsink name=out "
            f"tensortestsrc caps={CAPS_F32} ! m.sink_0 "
            f"tensortestsrc caps={CAPS_F32} ! m.sink_1"))
        assert "1-in/1-out" in plan.vetoes["m"]

    def test_dynamic_caps_break_downstream_of_crop(self):
        # crop emits FLEXIBLE caps: transforms after it cannot join a
        # static program
        plan = plan_fusion(pt.parse_launch(PLAN_LINES["crop_dynamic"]))
        assert plan.segments == []
        assert "1-in/1-out" in plan.vetoes["c"]  # structural veto first
        assert "a" in plan.vetoes

    def test_simlink_filter_exposes_no_traceable_invoke(self):
        plan = plan_fusion(pt.parse_launch(
            f"tensortestsrc caps={CAPS_F32} ! tensor_filter name=f "
            "framework=simlink ! tensor_transform name=a mode=arithmetic "
            "option=mul:2 ! appsink name=out"))
        assert plan.segments == []
        assert "no traceable invoke" in plan.vetoes["f"]


# Each launch line of these tests, planned by both packages: the same
# segments and the same veto keys. "{fw}" is the filter's framework.
PLAN_LINES = {
    "transform_run": f"tensortestsrc name=src caps={CAPS_F32} ! {RUN2} ! "
                     "appsink name=out",
    "queue_boundary": f"tensortestsrc name=src caps={CAPS_F32} ! tensor_transform "
                      "name=a mode=arithmetic option=mul:2 ! queue name=q ! "
                      "tensor_transform name=b mode=arithmetic option=add:1 "
                      "! appsink name=out",
    "run_of_one": f"tensortestsrc name=src caps={CAPS_F32} ! tensor_transform name=a "
                  "mode=arithmetic option=mul:2 ! appsink name=out",
    "no_device_fn": f"tensortestsrc name=src caps={CAPS_F32} ! tensor_transform "
                    "name=a mode=arithmetic option=mul:2 ! tensor_debug "
                    "name=i ! tensor_transform name=b mode=arithmetic "
                    "option=add:1 ! appsink name=out",
    "f64": f"tensortestsrc name=src caps={CAPS_F64} ! {RUN2} ! appsink name=out",
    "stand": f"tensortestsrc name=src caps={CAPS_F32} ! tensor_transform name=a "
             "mode=arithmetic option=mul:2 ! tensor_transform name=s "
             "mode=stand option=default ! appsink name=out",
    "host_decoder": f"tensortestsrc name=src caps={CAPS_F32} ! tensor_transform "
                    "name=a mode=arithmetic option=mul:2 ! tensor_decoder "
                    "name=d mode=image_labeling ! appsink name=out",
    "filter_decoder": f"tensortestsrc name=src caps={CAPS_SEG} ! tensor_filter "
                      "name=f {fw} model=zoo://toyseg ! tensor_decoder "
                      "name=d mode=image_segment ! appsink name=out",
    "filter_chain": f"tensortestsrc name=src caps={CAPS_SEG} ! tensor_filter name=f "
                    "{fw} model=zoo://toyseg ! tensor_filter name=g {fw} "
                    "model=zoo://toyscale ! tensor_decoder name=d "
                    "mode=image_segment ! appsink name=out",
    "invoke_dynamic": f"tensortestsrc name=src caps={CAPS_SEG} ! tensor_filter "
                      "name=f {fw} model=zoo://toyseg invoke-dynamic=true "
                      "! tensor_decoder name=d mode=image_segment ! "
                      "appsink name=out",
    "input_combination": f"tensortestsrc name=src caps={CAPS_PAIR} ! "
                         "tensor_filter name=f {fw} model=zoo://toyseg "
                         "input-combination=1 ! tensor_filter name=g {fw} "
                         "model=zoo://toyscale ! appsink name=out",
    "output_combination": f"tensortestsrc name=src caps={CAPS_SEG} ! "
                          "tensor_filter name=f {fw} model=zoo://toyseg "
                          "output-combination=o0 ! tensor_decoder name=d "
                          "mode=image_segment ! appsink name=out",
    "passthrough_queue": f"tensortestsrc name=src caps={CAPS_PAIR} ! "
                         "tensor_filter name=f {fw} model=zoo://toyseg "
                         "input-combination=1 output-combination=i0,o0 ! "
                         "queue name=q ! appsink name=out",
    "shared_key": f"tensortestsrc name=src caps={CAPS_SEG} ! tensor_filter "
                  "name=f {fw} model=zoo://toyseg shared-tensor-filter-key="
                  "plan_f ! tensor_filter name=g {fw} model=zoo://toyscale "
                  "shared-tensor-filter-key=plan_g ! appsink name=out",
    "filter_queue": f"tensortestsrc name=src caps={CAPS_SEG} ! tensor_filter name=f "
                    "{fw} model=zoo://toyseg ! queue name=q ! tensor_decoder name=d "
                    "mode=image_segment ! appsink name=out",
    "typecast_u8": f"tensortestsrc name=src caps={CAPS_U8} ! tensor_transform name=a "
                   "mode=typecast option=float32 ! tensor_transform name=b "
                   "mode=arithmetic option=add:3 ! tensor_transform name=c "
                   "mode=typecast option=uint8 ! appsink name=out",
    "video_segment": "videotestsrc name=src num-buffers=2 caps=\"video/x-raw,"
                     "format=GRAY8,width=8,height=8,framerate=30/1\" ! "
                     "tensor_converter name=conv ! tensor_transform name=t "
                     "mode=typecast option=float32 ! tensor_transform "
                     "name=r mode=dimchg option=0:2 ! appsink name=out",
    "multi_pad": "tensor_mux name=m ! appsink name=out "
                 f"tensortestsrc name=s0 caps={CAPS_F32} ! m.sink_0 "
                 f"tensortestsrc name=s1 caps={CAPS_F32} ! m.sink_1",
    "crop_dynamic": f"tensortestsrc name=s0 caps={CAPS_F32} ! tensor_crop "
                    "name=c c.src ! tensor_transform name=a mode=arithmetic "
                    "option=mul:2 ! tensor_transform name=b mode=arithmetic "
                    "option=add:1 ! appsink name=out "
                    "tensortestsrc name=s1 caps=other/tensors,format=static,"
                    "num_tensors=1,types=(string)uint32,dimensions=(string)4,"
                    "framerate=(fraction)0/1 ! c.info",
    "tee_filters_mux": "tensor_mux name=m ! tensor_demux name=d "
                       "d.src_0 ! appsink name=o0 d.src_1 ! appsink name=o1 "
                       f"tensortestsrc name=src caps={CAPS_SEG} ! tee name=t "
                       "t. ! queue name=q0 ! tensor_filter name=f {fw} "
                       "model=zoo://toyseg ! m.sink_0 "
                       "t. ! queue name=q1 ! tensor_filter name=g {fw} "
                       "model=zoo://toyseg ! tensor_transform name=a "
                       "mode=arithmetic option=mul:2 ! m.sink_1",
    "aggregator": f"tensortestsrc name=src caps={CAPS_F32} ! {RUN2} ! "
                  "tensor_aggregator name=g frames-out=2 ! tensor_transform "
                  "name=c mode=arithmetic option=add:1 ! tensor_transform "
                  "name=e mode=arithmetic option=mul:3 ! appsink name=out",
}


@pytest.mark.parametrize("key", sorted(PLAN_LINES))
def test_plan_parity_with_jax(key):
    line = PLAN_LINES[key]
    ours, theirs = _plans(line.replace("{fw}", PORT_FILTER),
                          line.replace("{fw}", "framework=jax"))
    _same_plan(ours, theirs)


class TestOptOut:
    def test_fuse_false_launch_prop(self):
        p = pt.parse_launch(f"fuse=false tensortestsrc caps={CAPS_F32} "
                            f"num-buffers=2 ! {RUN2} ! appsink name=out")
        assert p.fuse is False
        p.run(timeout=60)
        assert not _segments_of(p)
        assert p._fusion_plan is None

    def test_fuse_attr_opt_out(self):
        p = pt.parse_launch(f"tensortestsrc caps={CAPS_F32} num-buffers=2 ! "
                            f"{RUN2} ! appsink name=out")
        p.fuse = False
        p.run(timeout=60)
        assert not _segments_of(p)

    def test_fused_members_stay_addressable(self):
        p = _run(f"tensortestsrc caps={CAPS_F32} num-buffers=3 ! {RUN2} ! "
                 "appsink name=out")
        assert len(_segments_of(p)) == 1
        assert p["a"].stats["buffers"] == 0  # data bypassed the chain path
        assert p._fusion_plan.summary()["segments"] == [["a", "b"]]


TOYSEG_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models import convert, zoo


def get_model():
    apply_fn, module, in_info, out_info = zoo.build({name!r})
    flat = np.load({npz!r})
    module.load_state_dict(convert.toy_params_from_jax(
        {{k: flat[k] for k in flat.files}}))
    return apply_fn, module, in_info, out_info
'''


@pytest.fixture(scope="module")
def toy_models(tmp_path_factory):
    """Port model files serving the JAX zoo's toyseg/toyscale weights."""
    tmp = tmp_path_factory.mktemp("toy")
    files = {}
    for name in ("toyseg", "toyscale"):
        _, params, _, _ = jax_zoo.build(name)
        npz = tmp / f"{name}.npz"
        np.savez(npz, **{k: np.asarray(v) for k, v in params.items()})
        path = tmp / f"{name}.py"
        path.write_text(TOYSEG_PY.format(name=name, npz=str(npz)))
        files[name] = str(path)
    return files


class TestParity:
    def test_filter_decoder_chain(self, toy_models):
        """toyseg ! image_segment in ONE program: byte-identical to the
        port's two-element chain and to the JAX package's fused line."""
        tail = "! tensor_decoder mode=image_segment ! appsink name=out"
        src = f"tensortestsrc caps={CAPS_SEG} num-buffers=4 pattern=random"
        p = assert_parity(
            f"{src} ! tensor_filter {PORT_FILTER} "
            f"model={toy_models['toyseg']} {tail}",
            jax_desc=f"{src} ! tensor_filter framework=jax "
                     f"model=zoo://toyseg {tail}",
            min_frames=4)
        segs = _segments_of(p)
        assert len(segs) == 1
        assert segs[0].stats["fused_elements"] == 2

    def test_filter_chain_and_decoder(self, toy_models):
        """toyseg ! toyscale ! image_segment: two filters and the decoder
        in one program, exact."""
        tail = "! tensor_decoder mode=image_segment ! appsink name=out"
        src = f"tensortestsrc caps={CAPS_SEG} num-buffers=3 pattern=random"
        p = assert_parity(
            f"{src} ! tensor_filter {PORT_FILTER} "
            f"model={toy_models['toyseg']} ! tensor_filter {PORT_FILTER} "
            f"model={toy_models['toyscale']} {tail}",
            jax_desc=f"{src} ! tensor_filter framework=jax "
                     "model=zoo://toyseg ! tensor_filter framework=jax "
                     f"model=zoo://toyscale {tail}",
            min_frames=3)
        assert _segments_of(p)[0].stats["fused_elements"] == 3

    def test_transform_chain(self):
        assert_parity(
            f"tensortestsrc caps={CAPS_U8} num-buffers=4 ! "
            "tensor_transform mode=typecast option=float32 ! "
            "tensor_transform mode=arithmetic option=mul:2,add:1 ! "
            "tensor_transform mode=transpose option=1:0:2 ! "
            "appsink name=out", min_frames=4)

    def test_mux_and_transform_chain(self):
        # mux itself stays on the host; the transform run after it fuses
        p = assert_parity(
            "tensor_mux name=m ! "
            "tensor_transform name=a mode=typecast option=float32 ! "
            "tensor_transform name=b mode=arithmetic option=div:2 ! "
            "appsink name=out "
            f"tensortestsrc caps={CAPS_U8} num-buffers=3 ! m.sink_0 "
            f"tensortestsrc caps={CAPS_U8} num-buffers=3 ! m.sink_1",
            min_frames=3)
        assert p._fusion_plan.summary()["segments"] == [["a", "b"]]

    def test_crop_fed_by_fused_transforms(self):
        # transforms upstream of the (host-side) crop fuse; the cropped
        # bytes must be identical either way
        p = assert_parity(
            "tensor_crop name=c ! appsink name=out "
            f"tensortestsrc caps={CAPS_U8} num-buffers=5 ! "
            "tensor_transform name=a mode=typecast option=float32 ! "
            "tensor_transform name=b mode=arithmetic option=mul:2 ! "
            "c.raw "
            "tensortestsrc caps=other/tensors,format=static,num_tensors=1,"
            "types=(string)uint32,dimensions=(string)4,"
            "framerate=(fraction)0/1 num-buffers=5 ! c.info")
        assert len(_segments_of(p)) == 1

    def test_tee_legs_fuse_apart(self, toy_models):
        """Each leg of a tee after its queue plans on its own: the second
        leg's filter and transform fuse, the first leg's lone filter does
        not; the legs' outputs equal the JAX line's, byte for byte."""
        line = PLAN_LINES["tee_filters_mux"] \
            .replace("tensortestsrc name=src",
                     "tensortestsrc name=src num-buffers=3")
        port_line = line.replace("{fw}", PORT_FILTER).replace(
            "model=zoo://toyseg", f"model={toy_models['toyseg']}")
        p = assert_parity(port_line, sink="o1", min_frames=3,
                          jax_desc=line.replace("{fw}", "framework=jax"))
        assert [s.members for s in _segments_of(p)] == [[p["g"], p["a"]]]

    def test_typecast_to_uint8_parity(self):
        assert_parity(
            f"tensortestsrc caps={CAPS_U8} num-buffers=4 ! "
            "tensor_transform mode=typecast option=float32 ! "
            "tensor_transform mode=arithmetic option=add:3 ! "
            "appsink name=out", min_frames=4)


class TestJitCache:
    def test_one_compile_then_hits(self):
        line = (f"tensortestsrc caps={CAPS_F32} num-buffers=6 ! {RUN2} ! "
                "appsink name=out")
        seg = _segments_of(_run(line))[0]
        ref = _segments_of(_run(line, pkg=nt))[0]
        assert seg.stats["jit_misses"] == ref.stats["jit_misses"] == 1
        assert seg.stats["jit_hits"] == ref.stats["jit_hits"] == 5


class BoomDevice(TransformElement):
    """Test element: fuses eagerly, then its device program raises on
    every frame — the segment-level fault-path probe."""

    def transform(self, buf):
        return buf

    def device_fn(self, ctx=None):
        def fn(arrays):
            raise RuntimeError("injected device fault")
        return fn


class PassDevice(TransformElement):
    def transform(self, buf):
        return buf

    def device_fn(self, ctx=None):
        return lambda arrays: arrays


class TestSegmentFaults:
    def test_device_fault_escalates_under_default_policy(self):
        p = Pipeline()
        src = make_element("tensortestsrc", name="src")
        src.set_property("caps", CAPS_F32)
        src.set_property("num-buffers", 4)
        sink = make_element("appsink", name="out")
        p.add(src, BoomDevice(name="boom"), PassDevice(name="ok"), sink)
        p.link(src, p["boom"], p["ok"], sink)
        p.start()
        assert len(_segments_of(p)) == 1
        with pytest.raises(RuntimeError, match="injected device fault"):
            p.wait_eos(timeout=30)
        p.stop()


class TestLifecycle:
    def test_restart_does_not_refuse_or_double_fuse(self):
        p = pt.parse_launch(f"tensortestsrc caps={CAPS_F32} num-buffers=2 ! "
                            f"{RUN2} ! appsink name=out")
        p.start()
        assert len(_segments_of(p)) == 1
        p.stop()
        p.start()  # plan is sticky: no second rewiring
        assert len(_segments_of(p)) == 1
        p.stop()

    def test_fusion_failure_never_blocks_launch(self, monkeypatch):
        import nnstreamer_tpu_torch.fusion as fusion
        monkeypatch.setattr(
            fusion, "fuse_pipeline",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        p = pt.parse_launch(f"tensortestsrc caps={CAPS_F32} num-buffers=2 ! "
                            f"{RUN2} ! appsink name=out")
        p.run(timeout=60)  # unfused, but running
        assert not _segments_of(p)
        assert len(p["out"].buffers) == 2

    def test_in_flight_segment_matches_synchronous(self, toy_models):
        """A fused run whose filter asks for in-flight=3: the segment
        completes on its own window, in PTS order, with the same bytes."""
        line = (f"tensortestsrc caps={CAPS_SEG} num-buffers=6 pattern=random "
                f"! tensor_filter {PORT_FILTER} model={toy_models['toyseg']} "
                "in-flight={} ! tensor_decoder mode=image_segment ! "
                "appsink name=out")
        win, sync = _run(line.format(3)), _run(line.format(1))
        seg = _segments_of(win)[0]
        assert seg.transfer_report()["completed"] == 6
        assert [b.pts for b in win["out"].buffers] == \
            [b.pts for b in sync["out"].buffers]
        assert _frames(win) == _frames(sync)
