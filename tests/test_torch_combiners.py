"""The port's stream-shaping elements against the JAX package's, on the CPU.

Mirrors tests/test_combiners.py: tensor_mux under its four sync
policies, tensor_merge, tensor_demux, tensor_split, tensor_aggregator
(window, sliding window, split mode), tensor_if (average gate, custom
condition), tensor_rate, tensor_crop with a region stream, join, and
the natural order of request pads. Each case runs the same launch line
(or the same element calls) in both packages on the same numpy inputs
and holds the port to the reference's own assertions. Tolerance: none —
every element here moves or slices the bytes it is given, so outputs
(dtype, shape, bytes, PTS) are equal, exactly.

``tee`` and ``identity`` are covered in tests/test_torch_pipeline.py,
the ``tensor_region`` decoder in tests/test_torch_decoders.py, the
planner's multi-pad cases in tests/test_torch_fusion.py.
"""
import time

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.elements import flowctl as jax_flowctl
from nnstreamer_tpu.elements.combiner import pad_sort_key as jax_sort_key
from nnstreamer_tpu_torch.elements import flowctl
from nnstreamer_tpu_torch.elements.combiner import pad_sort_key

PKGS = (nt, pt)


def _key(buf):
    """A buffer as comparable (pts, [(dtype, shape, bytes), ...])."""
    chunks = []
    for c in buf.chunks:
        a = np.ascontiguousarray(c.host())
        chunks.append((str(a.dtype), tuple(a.shape), a.tobytes()))
    return buf.pts, chunks


def _both(run):
    """``run(pkg)`` in the JAX package and in the port; the port's result
    must equal the reference's. Returns the port's."""
    want, got = (run(pkg) for pkg in PKGS)
    assert got == want
    return got


def _mux_pipeline(pkg, sync_mode, sync_option=""):
    opt = f" sync-option={sync_option}" if sync_option else ""
    desc = (f'tensor_mux name=m sync-mode={sync_mode}{opt} '
            '! appsink name=out '
            'appsrc name=a caps="other/tensors,format=static,num_tensors=1,'
            'types=(string)int32,dimensions=(string)1,framerate=30/1" '
            '! m.sink_0 '
            'appsrc name=b caps="other/tensors,format=static,num_tensors=1,'
            'types=(string)int32,dimensions=(string)1,framerate=10/1" '
            '! m.sink_1')
    return pkg.parse_launch(desc)


def _buf(pkg, val, pts):
    return pkg.Buffer([pkg.Chunk(np.array([val], np.int32))], pts=pts)


def _vals(pipe):
    return [(o.pts, [int(c.host()[0]) for c in o.chunks])
            for o in pipe["out"].buffers]


def _feed(pipe, a_items, b_items, pkg, pause=0.0):
    pipe.start()
    for val, pts in a_items:
        pipe["a"].push_buffer(_buf(pkg, val, pts))
    if pause:
        pipe["a"].end_stream()
        time.sleep(pause)
    for val, pts in b_items:
        pipe["b"].push_buffer(_buf(pkg, val, pts))
    if not pause:
        pipe["a"].end_stream()
    pipe["b"].end_stream()
    pipe.wait_eos(timeout=30)
    pipe.stop()


def test_mux_nosync():
    def run(pkg):
        pipe = _mux_pipeline(pkg, "nosync")
        pipe.start()
        for i in range(3):
            pipe["a"].push_buffer(_buf(pkg, i, i * 100))
            pipe["b"].push_buffer(_buf(pkg, 10 + i, i * 300))
        pipe["a"].end_stream()
        pipe["b"].end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        cfg = pipe["out"].sinkpad.caps.to_config()
        return _vals(pipe), len(cfg.info), cfg.rate_n

    vals, n_tensors, rate_n = _both(run)
    assert vals == [(0, [0, 10]), (300, [1, 11]), (600, [2, 12])]
    assert n_tensors == 2 and rate_n == 10


def test_mux_slowest_drops_fast_pad():
    def run(pkg):
        pipe = _mux_pipeline(pkg, "slowest")
        _feed(pipe, [(i, i * 100) for i in range(6)],
              [(10 + i, i * 300) for i in range(3)], pkg)
        return _vals(pipe)

    assert _both(run) == [(0, [0, 10]), (300, [3, 11]), (600, [5, 12])]


def test_mux_basepad():
    def run(pkg):
        pipe = _mux_pipeline(pkg, "basepad", "1:150")
        _feed(pipe, [(i, i * 100) for i in range(6)],
              [(10 + i, i * 300) for i in range(3)], pkg)
        return _vals(pipe)

    assert [pts for pts, _ in _both(run)] == [0, 300, 600]


def test_mux_basepad_window_clamps_to_pts_delta():
    def run(pkg):
        pipe = _mux_pipeline(pkg, "basepad", "0:100")
        pipe.start()
        a, b = pipe["a"], pipe["b"]
        a.push_buffer(_buf(pkg, 0, 10))
        b.push_buffer(_buf(pkg, 100, 10))
        a.push_buffer(_buf(pkg, 1, 30))
        b.push_buffer(_buf(pkg, 101, 55))
        a.push_buffer(_buf(pkg, 2, 50))
        b.push_buffer(_buf(pkg, 102, 56))
        a.end_stream()
        b.end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        return _vals(pipe)[:3]

    assert _both(run) == [(10, [0, 100]), (30, [1, 100]), (50, [2, 101])]


def test_mux_collect_is_order_independent():
    def run(pkg):
        pipe = _mux_pipeline(pkg, "basepad", "0:100")
        _feed(pipe, [(0, 10), (1, 30), (2, 50)],
              [(100, 10), (101, 55), (102, 56)], pkg, pause=0.3)
        return _vals(pipe)[:2]

    assert _both(run) == [(10, [0, 100]), (30, [1, 100])]


def test_mux_refresh():
    def run(pkg):
        pipe = _mux_pipeline(pkg, "refresh")
        pipe.start()
        a, b = pipe["a"], pipe["b"]
        a.push_buffer(_buf(pkg, 0, 0))
        b.push_buffer(_buf(pkg, 10, 0))
        time.sleep(0.2)
        b.push_buffer(_buf(pkg, 11, 100))
        time.sleep(0.2)
        a.push_buffer(_buf(pkg, 1, 200))
        time.sleep(0.2)
        a.end_stream()
        b.end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        return [tuple(v) for _, v in _vals(pipe)]

    vals = _both(run)
    assert vals[0] == (0, 10)
    assert (0, 11) in vals and (1, 11) in vals


def test_merge_concatenates_dims():
    desc = ('tensor_merge name=m mode=linear option=0 sync-mode=nosync '
            '! appsink name=out '
            'appsrc name=a caps="other/tensors,format=static,num_tensors=1,'
            'types=(string)float32,dimensions=(string)4,framerate=30/1" '
            '! m.sink_0 '
            'appsrc name=b caps="other/tensors,format=static,num_tensors=1,'
            'types=(string)float32,dimensions=(string)2,framerate=30/1" '
            '! m.sink_1')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.start()
        pipe["a"].push_buffer(pkg.Buffer.from_arrays(
            [np.arange(4, dtype=np.float32)], pts=0))
        pipe["b"].push_buffer(pkg.Buffer.from_arrays(
            [np.array([9., 8.], np.float32)], pts=0))
        pipe["a"].end_stream()
        pipe["b"].end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        return ([_key(b) for b in pipe["out"].buffers],
                pipe["out"].sinkpad.caps.to_config().info[0].shape)

    outs, shape = _both(run)
    assert len(outs) == 1 and shape == (6,)
    np.testing.assert_array_equal(
        np.frombuffer(outs[0][1][0][2], np.float32), [0, 1, 2, 3, 9, 8])


def test_demux_tensorpick():
    desc = ("tensortestsrc pattern=counter num-buffers=2 caps=\"other/tensors,"
            "format=static,num_tensors=3,types=(string)'int8,int16,int32',"
            "dimensions=(string)'2,3,4'\" "
            '! tensor_demux name=d tensorpick=2,0 '
            'd.src_0 ! appsink name=o1  d.src_1 ! appsink name=o2')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.run(timeout=30)
        return ([_key(b) for b in pipe["o1"].buffers],
                [_key(b) for b in pipe["o2"].buffers],
                pipe["o1"].sinkpad.caps.to_config().info[0].shape)

    o1, o2, shape = _both(run)
    assert len(o1) == 2 and len(o2) == 2
    assert o1[0][1][0][0] == "int32" and o2[0][1][0][0] == "int8"
    assert shape == (4,)


def test_split_tiles_tensor():
    desc = ('tensortestsrc pattern=random num-buffers=1 caps="other/tensors,'
            'format=static,num_tensors=1,types=(string)uint8,'
            'dimensions=(string)3:4:4" '
            '! tensor_split name=s tensorseg=1:4:4,2:4:4 '
            's.src_0 ! appsink name=o1  s.src_1 ! appsink name=o2')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.run(timeout=30)
        return ([_key(b) for b in pipe["o1"].buffers],
                [_key(b) for b in pipe["o2"].buffers])

    o1, o2 = _both(run)
    assert o1[0][1][0][1] == (4, 4, 1) and o2[0][1][0][1] == (4, 4, 2)


def _run_line(desc):
    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.run(timeout=30)
        cfg = pipe["out"].sinkpad.caps.to_config()
        return ([_key(b) for b in pipe["out"].buffers],
                [b.duration for b in pipe["out"].buffers],
                [i.shape for i in cfg.info], (cfg.rate_n, cfg.rate_d))
    return _both(run)


def test_aggregator_window():
    outs, _, _, _ = _run_line(
        'tensortestsrc pattern=counter num-buffers=6 caps="other/tensors,'
        'format=static,num_tensors=1,types=(string)float32,'
        'dimensions=(string)2,framerate=(fraction)30/1" '
        '! tensor_aggregator frames-out=3 frames-flush=3 frames-dim=0 '
        '! appsink name=out')
    assert len(outs) == 2 and outs[0][1][0][1] == (6,)
    np.testing.assert_array_equal(
        np.frombuffer(outs[0][1][0][2], np.float32), [0, 0, 1, 1, 2, 2])


def test_aggregator_sliding_window():
    outs, _, _, _ = _run_line(
        'tensortestsrc pattern=counter num-buffers=4 caps="other/tensors,'
        'format=static,num_tensors=1,types=(string)float32,'
        'dimensions=(string)1" '
        '! tensor_aggregator frames-out=2 frames-flush=1 frames-dim=0 '
        '! appsink name=out')
    vals = [tuple(np.frombuffer(o[1][0][2], np.float32)) for o in outs]
    assert vals == [(0, 1), (1, 2), (2, 3)]


def test_aggregator_split_mode():
    outs, _, shapes, rate = _run_line(
        'tensortestsrc pattern=counter num-buffers=2 caps="other/tensors,'
        'format=static,num_tensors=1,types=(string)float32,'
        'dimensions=(string)2:4,framerate=(fraction)10/1" '
        '! tensor_aggregator frames-in=4 frames-out=2 frames-dim=1 '
        '! appsink name=out')
    assert len(outs) == 4 and outs[0][1][0][1] == (2, 2)
    assert shapes == [(2, 2)] and rate[0] == 20


@pytest.mark.parametrize("concat,dims", [("false", (32, 8, 8, 3)),
                                         ("true", (256, 8, 3))])
def test_aggregator_batches_frames_for_a_batched_filter(concat, dims):
    """The aggregator settings that turn per-frame 3:W:H into the batched
    3:W:H:N a batched filter takes: ``concat=false`` stacks on a new
    outermost axis; ``concat=true`` with ``frames-dim=3`` joins along the
    height, since a 3-dim frame has no dim 3. Then ``frames-in=N
    frames-out=1 frames-dim=1`` splits an [N, C] output back into [1, C]
    frames."""
    outs, _, shapes, _ = _run_line(
        'tensortestsrc pattern=random num-buffers=64 caps="other/tensors,'
        'format=static,num_tensors=1,types=(string)uint8,'
        'dimensions=(string)3:8:8" '
        f'! tensor_aggregator frames-out=32 frames-dim=3 concat={concat} '
        '! appsink name=out')
    assert len(outs) == 2 and shapes == [dims]
    outs, _, shapes, _ = _run_line(
        'tensortestsrc pattern=counter num-buffers=2 caps="other/tensors,'
        'format=static,num_tensors=1,types=(string)float32,'
        'dimensions=(string)5:32" '
        '! tensor_aggregator frames-in=32 frames-out=1 frames-dim=1 '
        '! appsink name=out')
    # caps drop the leading 1 (a trailing :1 of the dims); chunks keep it
    assert len(outs) == 64 and shapes == [(5,)]
    assert all(chunks[0][1] == (1, 5) for _, chunks in outs)


def test_tensor_if_average_gate():
    desc = ('appsrc name=in caps="other/tensors,format=static,num_tensors=1,'
            'types=(string)float32,dimensions=(string)2" '
            '! tensor_if name=f compared-value=TENSOR_AVERAGE_VALUE '
            'compared-value-option=0 operator=GT supplied-value=5 '
            'then=PASSTHROUGH else=SKIP '
            'f.src_0 ! appsink name=out')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.start()
        for v in (10., 1., 8.):
            pipe["in"].push_buffer(pkg.Buffer.from_arrays(
                [np.array([v, v], np.float32)]))
        pipe["in"].end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        return [float(o.chunks[0].host()[0]) for o in pipe["out"].buffers]

    assert _both(run) == [10.0, 8.0]


@pytest.mark.parametrize("option,supplied,op", [
    ("1:0,0", "4", "EQ"), ("0:1,0", "2:6", "RANGE_INCLUSIVE"),
    ("2:1,1", "-1", "LT")])
def test_tensor_if_a_value(option, supplied, op):
    """A_VALUE indexes innermost-first (``d0:d1,tensor``) in both
    packages; the port reads just that element."""
    desc = ('appsrc name=in caps="other/tensors,format=static,num_tensors=2,'
            "types=(string)'float32,int16',dimensions=(string)'3:2,3:2'\" "
            f'! tensor_if name=f compared-value=A_VALUE '
            f'compared-value-option={option} operator={op} '
            f'supplied-value={supplied} then=TENSORPICK then-option=1 '
            'else=PASSTHROUGH f.src_0 ! appsink name=yes '
            'f.src_1 ! appsink name=no')
    rng = np.random.default_rng(4)
    frames = [(rng.integers(0, 8, (2, 3)).astype(np.float32),
               rng.integers(-3, 3, (2, 3)).astype(np.int16))
              for _ in range(12)]

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.start()
        for i, arrs in enumerate(frames):
            pipe["in"].push_buffer(pkg.Buffer.from_arrays(list(arrs), pts=i))
        pipe["in"].end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        return ([_key(b) for b in pipe["yes"].buffers],
                [_key(b) for b in pipe["no"].buffers])

    yes, no = _both(run)
    assert yes and no and len(yes) + len(no) == len(frames)
    assert all(len(chunks) == 1 for _, chunks in yes)


def test_tensor_if_custom_condition():
    desc = ('appsrc name=in caps="other/tensors,format=static,num_tensors=1,'
            'types=(string)int32,dimensions=(string)1" '
            '! tensor_if name=f compared-value=CUSTOM '
            'compared-value-option=evens then=PASSTHROUGH else=SKIP '
            'f.src_0 ! appsink name=out')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.start()
        for i in range(5):
            pipe["in"].push_buffer(pkg.Buffer.from_arrays(
                [np.array([i], np.int32)]))
        pipe["in"].end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        return [int(o.chunks[0].host()[0]) for o in pipe["out"].buffers]

    def evens(b):
        return int(b.chunks[0].host()[0]) % 2 == 0

    for mod in (jax_flowctl, flowctl):
        mod.register_if_condition("evens", evens)
    try:
        assert _both(run) == [0, 2, 4]
    finally:
        for mod in (jax_flowctl, flowctl):
            mod.unregister_if_condition("evens")


def test_tensor_rate_downsamples():
    desc = ('tensortestsrc pattern=counter num-buffers=10 caps="other/tensors,'
            'format=static,num_tensors=1,types=(string)float32,'
            'dimensions=(string)1,framerate=(fraction)30/1" '
            '! tensor_rate name=r framerate=10/1 ! appsink name=out')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.run(timeout=30)
        cfg = pipe["out"].sinkpad.caps.to_config()
        st = pipe["r"].stats
        return ([_key(b) for b in pipe["out"].buffers],
                [b.duration for b in pipe["out"].buffers],
                {k: st[k] for k in ("in", "out", "dup", "drop")},
                (cfg.rate_n, cfg.rate_d))

    outs, _, stats, rate = _both(run)
    assert 3 <= len(outs) <= 4 and stats["drop"] >= 6
    assert rate == (10, 1)


def test_tensor_rate_duplicates_into_gaps():
    """A 5 fps stream into framerate=10/1: every frame is followed by a
    duplicate of itself at the next 100 ms slot."""
    desc = ('tensortestsrc pattern=counter num-buffers=4 caps="other/tensors,'
            'format=static,num_tensors=1,types=(string)int32,'
            'dimensions=(string)1,framerate=(fraction)5/1" '
            '! tensor_rate name=r framerate=10/1 ! appsink name=out')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.run(timeout=30)
        st = pipe["r"].stats
        return ([_key(b) for b in pipe["out"].buffers],
                {k: st[k] for k in ("in", "out", "dup", "drop")})

    outs, stats = _both(run)
    assert stats == {"in": 4, "out": 7, "dup": 3, "drop": 0}
    assert [pts for pts, _ in outs] == [i * 100_000_000 for i in range(7)]


def test_crop_with_region_stream():
    frame = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
    regions = np.array([[2, 2, 4, 4], [0, 0, 2, 2], [6, 6, 5, 5],
                        [1, 1, 0, 3]], np.uint32)

    def run(pkg):
        from importlib import import_module
        basic = import_module(f"{pkg.__name__}.pipeline.basic")
        crop = pkg.make_element("tensor_crop")
        sink = basic.AppSink("csink")
        crop.src_pads["src"].link(sink.sinkpad)
        crop.do_chain(crop.sink_pads["raw"],
                      pkg.Buffer.from_arrays([frame], pts=7))
        crop.do_chain(crop.sink_pads["info"],
                      pkg.Buffer.from_arrays([regions]))
        return [_key(b) for b in sink.buffers], \
            [[str(c.meta.format) for c in b.chunks] for b in sink.buffers]

    outs, fmts = _both(run)
    assert len(outs) == 1 and outs[0][0] == 7
    shapes = [shape for _, shape, _ in outs[0][1]]
    # the region reaching past the frame is clipped; w=0 is skipped
    assert shapes == [(4, 4, 3), (2, 2, 3), (2, 2, 3)]
    assert outs[0][1][0][2] == frame[2:6, 2:6].tobytes()
    assert fmts == [["flexible"] * 3]


def test_crop_pairs_streams_through_a_pipeline():
    """raw and info from two sources pair one to one in arrival order;
    the crop's output caps are flexible at the raw pad's rate."""
    raw_caps = ('other/tensors,format=static,num_tensors=1,'
                'types=(string)uint8,dimensions=(string)3:8:8,'
                'framerate=(fraction)30/1')
    info_caps = ('other/tensors,format=static,num_tensors=1,'
                 'types=(string)uint32,dimensions=(string)4:2,'
                 'framerate=(fraction)30/1')
    desc = (f'tensor_crop name=c ! appsink name=out '
            f'appsrc name=raw caps="{raw_caps}" ! queue ! c.raw '
            f'appsrc name=info caps="{info_caps}" ! queue ! c.info')
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 255, (8, 8, 3), np.uint8, endpoint=True)
              for _ in range(5)]
    regs = [np.array([[i, 1, 3, 2], [0, i, 2, 3]], np.uint32)
            for i in range(5)]

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.start()
        for i in range(5):
            pipe["raw"].push_buffer(pkg.Buffer.from_arrays([frames[i]],
                                                           pts=i))
            pipe["info"].push_buffer(pkg.Buffer.from_arrays([regs[i]]))
        pipe["raw"].end_stream()
        pipe["info"].end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        cfg = pipe["out"].sinkpad.caps.to_config()
        return [_key(b) for b in pipe["out"].buffers], \
            (str(cfg.format), cfg.rate_n)

    outs, (fmt, rate) = _both(run)
    assert fmt == "flexible" and rate == 30
    assert [pts for pts, _ in outs] == list(range(5))
    for i, (_, chunks) in enumerate(outs):
        assert chunks[0][2] == frames[i][1:3, i:i + 3].tobytes()


def test_join_first_come():
    desc = ('join name=j ! appsink name=out '
            'appsrc name=a caps="other/tensors,format=static,num_tensors=1,'
            'types=(string)int32,dimensions=(string)1" ! j.sink_0 '
            'appsrc name=b caps="other/tensors,format=static,num_tensors=1,'
            'types=(string)int32,dimensions=(string)1" ! j.sink_1')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.start()
        pipe["a"].push_buffer(_buf(pkg, 1, 0))
        time.sleep(0.1)
        pipe["b"].push_buffer(_buf(pkg, 2, 1))
        time.sleep(0.1)
        pipe["a"].end_stream()
        pipe["b"].end_stream()
        pipe.wait_eos(timeout=30)
        pipe.stop()
        return sorted(int(o.chunks[0].host()[0]) for o in pipe["out"].buffers)

    assert _both(run) == [1, 2]


def test_pad_sort_key_natural_order():
    names = [f"sink_{i}" for i in range(12)]
    shuffled = sorted(names)                       # lexicographic scramble
    assert sorted(shuffled, key=pad_sort_key) == names
    assert [pad_sort_key(n) for n in shuffled + ["src"]] == \
        [jax_sort_key(n) for n in shuffled + ["src"]]


@pytest.mark.parametrize("line", [
    "tee", "identity", "tensor_mux", "tensor_merge", "join",
    "tensor_demux", "tensor_split", "tensor_aggregator", "tensor_crop",
    "tensor_if", "tensor_rate"])
def test_element_names_registered_in_both(line):
    """Every stream-shaping element name makes an element in both
    packages, with the same property names."""
    jax_el = nt.make_element(line)
    el = pt.make_element(line)
    assert set(el._prop_defaults) - {"on-error"} == \
        set(jax_el._prop_defaults) - {"on-error", "trace-export"}
    assert set(el.SINK_TEMPLATES) == set(jax_el.SINK_TEMPLATES)
    assert set(el.SRC_TEMPLATES) == set(jax_el.SRC_TEMPLATES)


@pytest.mark.parametrize("concat", ["true", "false"])
def test_aggregator_bfloat16_stream(concat):
    """bfloat16 frames come back from the port's ``host()`` as CPU
    tensors (numpy has no bf16); the aggregator joins them as the JAX
    package joins its ml_dtypes arrays: the same values, bit for bit."""
    desc = ('tensortestsrc pattern=random num-buffers=4 caps="other/tensors,'
            'format=static,num_tensors=1,types=(string)bfloat16,'
            'dimensions=(string)3:2" '
            f'! tensor_aggregator frames-out=2 frames-dim=1 concat={concat} '
            '! appsink name=out')

    def run(pkg):
        pipe = pkg.parse_launch(desc)
        pipe.run(timeout=30)
        out = []
        for b in pipe["out"].buffers:
            a = b.chunks[0].host()
            a = a.float().numpy() if hasattr(a, "float") \
                else np.asarray(a, np.float32)
            out.append((tuple(a.shape), a.tobytes()))
        return out

    outs = _both(run)
    assert len(outs) == 2
    assert outs[0][0] == ((4, 3) if concat == "true" else (2, 2, 3))
