"""The port's tensor_src_iio (elements/iio.py) against the JAX package's,
on the CPU.

Each case of tests/test_iio.py (merged channels, unmerged channels, a
shifted and masked 12-bit channel, mixed storage sizes with the kernel's
alignment, one-shot sysfs reads, a missing device) builds one fake sysfs
tree and buffer file, runs the same line in both packages over it, and
holds the port to the JAX package: the same chunks, bit for bit (float32
host arrays), and the same caps; and both to the values the JAX test
expects.

Tolerance: none; every comparison is bitwise.
"""
import struct

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt

PKGS = {"jax": nt, "port": pt}


@pytest.fixture(autouse=True)
def _keep_element_name_counters():
    """Each package names an unnamed element from a process-wide counter;
    this file's lines (often in one package only) leave both counters as
    they found them, so a later file in the same process that compares
    the two packages' generated names sees what it would without this
    one."""
    from nnstreamer_tpu.pipeline.element import Element as NtElement
    from nnstreamer_tpu_torch.pipeline.element import Element
    saved = Element._anon_counter[0], NtElement._anon_counter[0]
    yield
    Element._anon_counter[0], NtElement._anon_counter[0] = saved


def _make_device(tmp_path, samples, name="fake_accel"):
    """tests/test_iio.py's tree: 2 enabled s16 channels + 1 disabled,
    and a device node of interleaved little-endian frames."""
    base = tmp_path / "sys"
    dev = base / "iio:device0"
    scan = dev / "scan_elements"
    scan.mkdir(parents=True)
    (dev / "name").write_text(name + "\n")
    for ch, idx, en in (("in_accel_x", 0, 1), ("in_accel_y", 1, 1),
                        ("in_accel_z", 2, 0)):
        (scan / f"{ch}_en").write_text(str(en))
        (scan / f"{ch}_index").write_text(str(idx))
        (scan / f"{ch}_type").write_text("le:s16/16>>0\n")
    (dev / "in_accel_x_scale").write_text("0.5")
    (dev / "in_accel_y_offset").write_text("10")
    devdir = tmp_path / "dev"
    devdir.mkdir()
    payload = b"".join(struct.pack("<hh", x, y) for x, y in samples)
    (devdir / "iio:device0").write_bytes(payload)
    return base, devdir


def _one_channel_tree(tmp_path, name, chans, payload):
    """A tree of the channels given ((name, index, type string)) and a
    device node holding ``payload``."""
    base = tmp_path / "sys"
    dev = base / "iio:device0"
    scan = dev / "scan_elements"
    scan.mkdir(parents=True)
    (dev / "name").write_text(name + "\n")
    for ch, idx, tstr in chans:
        (scan / f"{ch}_en").write_text("1")
        (scan / f"{ch}_index").write_text(str(idx))
        (scan / f"{ch}_type").write_text(tstr)
    devdir = tmp_path / "dev"
    devdir.mkdir()
    (devdir / "iio:device0").write_bytes(payload)
    return base, devdir


def _case_merged(tmp_path):
    base, devdir = _make_device(
        tmp_path, [(100, -2), (200, 4), (-300, 6), (400, 8)])
    line = (f"tensor_src_iio device=fake_accel base-dir={base} "
            f"dev-dir={devdir} buffer-capacity=2 num-buffers=2 "
            "! appsink name=out")
    return line, [[[50, 8], [100, 14]], [[-150, 16], [200, 18]]]


def _case_unmerged(tmp_path):
    base, devdir = _make_device(tmp_path, [(1, 2), (3, 4)])
    line = (f"tensor_src_iio device-number=0 base-dir={base} "
            f"dev-dir={devdir} buffer-capacity=2 num-buffers=1 "
            "merge-channels-data=false ! appsink name=out")
    return line, [[[0.5], [1.5]], [[12], [14]]]


def _case_shift_mask(tmp_path):
    vals = [100 << 4, (-5 & 0xFFF) << 4]
    base, devdir = _one_channel_tree(
        tmp_path, "adc", [("in_voltage0", 0, "le:s12/16>>4")],
        b"".join(struct.pack("<H", v & 0xFFFF) for v in vals))
    line = (f"tensor_src_iio device=adc base-dir={base} dev-dir={devdir} "
            "buffer-capacity=2 num-buffers=1 ! appsink name=out")
    return line, [[[100.0], [-5.0]]]


def _case_mixed_storage(tmp_path):
    frames = b"".join(struct.pack("<BxH", a, b & 0xFFFF)
                      for a, b in ((5, 1000), (7, -1000)))
    base, devdir = _one_channel_tree(
        tmp_path, "mixed", [("in_a", 0, "le:u8/8>>0"),
                            ("in_b", 1, "le:s16/16>>0")], frames)
    line = (f"tensor_src_iio device=mixed base-dir={base} dev-dir={devdir} "
            "buffer-capacity=2 num-buffers=1 ! appsink name=out")
    return line, [[[5, 1000], [7, -1000]]]


def _case_oneshot(tmp_path):
    base, devdir = _make_device(tmp_path, [(0, 0)])
    dev = base / "iio:device0"
    (dev / "in_accel_x_raw").write_text("42")
    (dev / "in_accel_y_raw").write_text("-7")
    line = (f"tensor_src_iio device=fake_accel base-dir={base} "
            f"dev-dir={devdir} mode=one-shot num-buffers=1 "
            "! appsink name=out")
    return line, [[[21.0, 3.0]]]


CASES = {"merged": _case_merged, "unmerged": _case_unmerged,
         "shift_mask": _case_shift_mask, "mixed_storage": _case_mixed_storage,
         "oneshot": _case_oneshot}


def _run(pkg, line):
    p = PKGS[pkg].parse_launch(line)
    p.run(15)
    chunks = [[np.asarray(c.host()) for c in b.chunks]
              for b in p["out"].buffers]
    return chunks, str(p["out"].sinkpad.caps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_iio_port_equals_jax(case, tmp_path):
    line, expect = CASES[case](tmp_path)
    port, port_caps = _run("port", line)
    jax, jax_caps = _run("jax", line)
    assert port_caps == jax_caps
    assert [[c.dtype for c in b] for b in port] == \
        [[np.dtype(np.float32)] * len(b) for b in jax]
    assert [[c.shape for c in b] for b in port] == \
        [[c.shape for c in b] for b in jax]
    assert [[c.tobytes() for c in b] for b in port] == \
        [[c.tobytes() for c in b] for b in jax]
    if case == "unmerged":
        got = [[c.ravel().tolist() for c in port[0]]]
        want = [[list(np.ravel(e)) for e in expect]]
    else:
        got = [np.concatenate(b, axis=1).tolist() for b in port]
        want = expect
    np.testing.assert_array_equal(np.asarray(got, np.float64),
                                  np.asarray(want, np.float64))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_missing_device_errors(pkg, tmp_path):
    (tmp_path / "sys").mkdir()
    p = PKGS[pkg].parse_launch(
        f'tensor_src_iio device=nope base-dir={tmp_path / "sys"} ! fakesink')
    with pytest.raises(ValueError, match="not found"):
        p.start()
    p.stop()
