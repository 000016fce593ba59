"""The port's obs-overhead gate, on the CPU: the harness and the verdict.

``tools/torch_obs_overhead.py`` runs the devres row in subprocesses with
span recording on (``NNS_TPU_OBS=1``) and hard off (``=0``), interleaved,
each arm its best of N, and fails above 3 % fps. Here: each arm's child
prints one JSON fps line after a few CPU frames and the off arm records
no span; the best-of arithmetic gives the JAX tool's exit codes; a child
that fails is a harness failure (exit 2). No timing verdict is asserted
here: fps on a shared CPU says nothing of the card.
"""
import json
import os
import subprocess
import sys

import pytest

from torch_gate_parity import ROOT, tool


@pytest.fixture(scope="module")
def obs():
    return tool("torch_obs_overhead")


@pytest.mark.parametrize("on", [False, True])
def test_each_arm_prints_one_fps_line(obs, on):
    res = obs.run_once(on, "cpu", frames=6, warmup=2)
    assert res["fps"] > 0 and res["device"] == "cpu"
    assert res["obs"] is on
    assert (res["spans"] > 0) is on
    # the child's own counters: the CPU row launches no hand kernel
    assert res["launches"] == {"attention": 0, "normalize": 0}


def test_child_prints_one_json_line_last():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_obs_overhead.py"),
         "--child", "--device", "cpu", "--frames", "4", "--warmup", "1"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, NNS_TPU_OBS="0", NNS_TPU_FLIGHT_DIR=""),
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["spans"] == 0 and line["fps"] > 0


@pytest.mark.parametrize("off,on,rc", [
    ([100.0, 98.0, 99.0], [99.0, 97.5, 98.0], 0),    # 1 % below
    ([100.0, 90.0], [97.0, 96.0], 0),                # exactly 3 %
    ([100.0, 90.0], [96.9, 80.0], 1),                # 3.1 % below
    ([50.0, 100.0, 60.0], [101.0, 20.0, 30.0], 0),   # best of each arm
    ([100.0], [120.0], 0),                           # tracing faster
])
def test_best_of_verdict(obs, off, on, rc):
    loss, got = obs.verdict(off, on, 3.0)
    assert got == rc
    assert loss == pytest.approx((max(off) - max(on)) / max(off) * 100)


def test_a_failing_child_is_a_harness_failure(obs, monkeypatch):
    def broken(*args, **kwargs):
        raise obs.HarnessError("child exited 1")
    monkeypatch.setattr(obs, "run_once", broken)
    res = obs.run("cpu", frames=4, warmup=1, reps=1)
    assert res["rc"] == 2 and "child exited 1" in res["error"]


def test_interleaves_the_arms_and_keeps_every_rep(obs, monkeypatch):
    order = []

    def fake(on, device, frames, warmup):
        order.append(on)
        return {"fps": 100.0 if on else 101.0, "spans": int(on),
                "launches": {"attention": 12 * on, "normalize": 1}}
    monkeypatch.setattr(obs, "run_once", fake)
    res = obs.run("cpu", frames=4, warmup=1, reps=3)
    assert order == [False, True] * 3
    assert res["fps_off"] == [101.0] * 3 and res["rc"] == 0
    # each child's launches, summed over every rep of both arms
    assert res["launches"] == {"attention": 36, "normalize": 6}


def test_card_row_is_bench_devres_at_full_width(obs):
    """The row on the card is bench.py's bench_pipeline_devres: batch-32
    MobileNet-v2, device-resident unique frames, queues of 8 and 32,
    prefetch-host, 40 warm-up and 200 measured buffers."""
    desc = obs.row_desc("cuda", 200, 40)
    assert "dimensions=(string)3:224:224:32" in desc
    assert "model=zoo://mobilenet_v2 " in desc
    assert "device=true unique=true num-buffers=240" in desc
    assert "max-size-buffers=8" in desc and "max-size-buffers=32" in desc
    assert "prefetch-host=true" in desc and "accelerator" not in desc
    assert obs.ROWS["cuda"][3:] == (200, 40)


def test_the_card_row_raises_without_cuda(obs):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        obs.run("cuda")
