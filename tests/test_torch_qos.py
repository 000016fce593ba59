"""QoS throttling in the port against the JAX package, on the CPU.

Mirrors tests/test_qos.py's ``TestQosThrottling`` (tensor_rate with
throttle on and off), adds ``appsink qos=true`` with a render the test
slows down, the throttle in front of an in-flight window, and pins what
a fused segment does with a QoS event. The JAX side's ``custom-easy``
counter is replaced in both packages by ``framework=simlink`` (an
affine invoke, counted by the filter's invoke counter). Each line runs
in both packages and the reference's assertions hold for both. Which
frames are dropped depends on when the QoS event lands against the
frames in flight, so the drop counts are held to the invariants
(``invokes + qos_dropped`` equals the frames sent), not to each other.
"""
import time

import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt

PKGS = (nt, pt)
CAPS_F32 = ("other/tensors,format=static,num_tensors=1,types=float32,"
            "dimensions=8,framerate=0/1")
CAPS_30FPS = CAPS_F32.replace("framerate=0/1", "framerate=30/1")
CAPS_60FPS = CAPS_F32.replace("framerate=0/1", "framerate=60/1")


def _run(pkg, desc, fuse=True, setup=None, timeout=20):
    p = pkg.parse_launch(desc)
    p.fuse = fuse
    if setup is not None:
        setup(p)
    p.run(timeout)
    return p


def _invokes(filt):
    return filt._invoke_count


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_rate_throttle_skips_upstream_invokes(pkg):
    # 30 fps source into a 10 fps tensor_rate: without QoS the filter
    # would invoke 30 times; with throttle=true the rate element's QoS
    # event makes the filter skip frames before the invoke
    p = _run(pkg,
             f"tensortestsrc caps={CAPS_30FPS} num-buffers=30 ! "
             "tensor_filter name=f framework=simlink ! "
             "tensor_rate name=r framerate=10/1 throttle=true ! "
             "appsink name=out")
    f = p["f"]
    assert f.stats["qos_dropped"] > 0
    assert _invokes(f) + f.stats["qos_dropped"] == 30
    assert _invokes(f) < 30
    # rate still emits its nominal cadence from what it receives
    assert p["r"].stats["out"] == len(p["out"].buffers)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_throttle_off_means_no_qos_drop(pkg):
    p = _run(pkg,
             f"tensortestsrc caps={CAPS_30FPS} num-buffers=15 ! "
             "tensor_filter name=f framework=simlink ! "
             "tensor_rate framerate=10/1 throttle=false ! fakesink")
    assert p["f"].stats["qos_dropped"] == 0
    assert _invokes(p["f"]) == 15


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_throttle_reaches_a_filter_with_a_window(pkg):
    """The drop check runs before the in-flight dispatch too: a dropped
    frame takes no window slot."""
    p = _run(pkg,
             f"tensortestsrc caps={CAPS_30FPS} num-buffers=30 ! "
             "tensor_filter name=f framework=simlink in-flight=4 ! "
             "tensor_rate name=r framerate=10/1 throttle=true ! "
             "appsink name=out", fuse=False)
    f = p["f"]
    assert f.stats["qos_dropped"] > 0
    assert _invokes(f) + f.stats["qos_dropped"] == 30
    assert f.transfer_report()["completed"] == _invokes(f)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_appsink_qos_throttles_a_slow_render(pkg):
    """A sink whose render takes 20 ms of a 16.7 ms frame sends QoS
    upstream (one event per throttle episode, re-sent on >25 % drift),
    and the filter skips invokes; without qos=true it sends none."""
    events = {}

    def setup(p):
        p["out"].connect(lambda buf: time.sleep(0.02))
        f = p["f"]
        events[p] = []
        orig = f.handle_upstream_event

        def counted(pad, event):
            events[p].append(event)
            orig(pad, event)

        f.handle_upstream_event = counted

    desc = (f"tensortestsrc caps={CAPS_60FPS} num-buffers=30 ! "
            "tensor_filter name=f framework=simlink ! appsink name=out")
    p = _run(pkg, desc.replace("appsink name=out",
                               "appsink name=out qos=true"), setup=setup)
    f = p["f"]
    assert events[p] and events[p][0].proportion > 1.0
    assert events[p][0].period_ns > 16_666_666
    assert f.stats["qos_dropped"] > 0
    assert _invokes(f) + f.stats["qos_dropped"] == 30
    assert len(p["out"].buffers) == _invokes(f)
    plain = _run(pkg, desc, setup=setup)
    assert not events[plain] and plain["f"].stats["qos_dropped"] == 0


def test_appsink_qos_needs_no_port_refusal():
    """qos=true is a ported property: the port starts such a sink."""
    p = pt.parse_launch(f"tensortestsrc caps={CAPS_30FPS} num-buffers=2 "
                        "! appsink name=out qos=true")
    p.run(10)
    assert len(p["out"].buffers) == 2


def _filter(pkg):
    return ("framework=jax" if pkg is nt
            else "framework=torch-cuda accelerator=true:cpu")


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
@pytest.mark.parametrize("fuse", [True, False])
def test_fused_segment_passes_qos_by(pkg, fuse):
    """A filter fused with the element after it is not throttled: the
    fused segment has no QoS handler, so a tensor_rate's event passes it
    by to the source (which ignores it), and every frame is invoked.
    Unfused, the same filter drops frames before its invoke."""
    caps = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)8:8,"
            "framerate=(fraction)30/1")
    p = _run(pkg,
             f"tensortestsrc caps={caps} num-buffers=30 ! "
             f"tensor_filter name=f {_filter(pkg)} model=zoo://toyseg ! "
             "tensor_transform name=t mode=arithmetic option=mul:2 ! "
             "tensor_rate name=r framerate=10/1 throttle=true ! "
             "appsink name=out", fuse=fuse, timeout=60)
    segs = [e for e in p.elements.values()
            if getattr(e, "IS_FUSED_SEGMENT", False)]
    assert p["r"].stats["drop"] > 0
    if fuse:
        (seg,) = segs
        assert [m.name for m in seg.members] == ["f", "t"]
        assert seg.stats["jit_hits"] + seg.stats["jit_misses"] == 30
        assert p["f"].stats["qos_dropped"] == 0
    else:
        assert not segs
        assert p["f"].stats["qos_dropped"] > 0
        assert _invokes(p["f"]) + p["f"].stats["qos_dropped"] == 30
