"""The port's training path (datareposrc/datareposink, tensor_trainer
with ``framework=torch-cuda``, trainers/, ``params_dir``, the GPT loss)
against the JAX package's, on the CPU.

Mirrors tests/test_training.py (the datarepo reader and writer, the
trainer learning and saving, resume from model-load-path, the GPT
train-then-serve loop; the mesh cases' sharded steps are
tests/test_torch_mesh_filter.py's, a mesh larger than the one host
device is refused below) and holds the port to the JAX package where
both run:

* datareposrc emits the JAX element's samples, byte for byte, in the
  JAX element's order (ranges, epochs, shuffle, tensors-sequence), and
  datareposink writes the JAX element's data file and JSON index;
* the MLP trainer (f32, ``zoo://mlp``) started from the JAX init
  (converted with ``models.convert``, saved with the port's
  ``save_params`` and read through ``model-load-path``) gives the JAX
  trainer's ``[loss, acc, vloss, vacc]`` records over 20 epochs, and the
  same Adam moments and step count (both are Adam at optax's defaults);
* a tiny ViT's loss and gradients on one batch (bf16 compute) match the
  JAX trainer's, by cosine and by the largest error against the largest
  gradient; then the epoch records of a few steps;
* the GPT's next-token loss matches JAX's ``transformer.loss_fn``;
* the refusals and divergences ROADMAP.md §C lists.

Every tolerance is stated beside its comparison.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu.trainers import jax_trainer
from nnstreamer_tpu_torch.models import convert
from nnstreamer_tpu_torch.trainers import (find_trainer, restore_params,
                                           save_params, torch_cuda_trainer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP = "zoo://mlp?in_dim=8&hidden=16&out_dim=4&lr=0.05&dtype=float32"
TINY_VIT = dict(size="32", patch="8", d_model="32", layers="2",
                heads="2", classes="4")


def _write_dataset(tmp_path, n=32, in_dim=8, classes=4):
    """tests/test_training.py's dataset: float32[in_dim] input +
    float32[classes] one-hot, class means offset so it is learnable."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(n, in_dim)).astype(np.float32)
    ys = np.zeros((n, classes), np.float32)
    labels = rng.integers(0, classes, n)
    ys[np.arange(n), labels] = 1.0
    xs += labels[:, None] * 2.0
    data = tmp_path / "train.data"
    with open(data, "wb") as f:
        for x, y in zip(xs, ys):
            f.write(x.tobytes() + y.tobytes())
    index = {
        "gst_caps": ("other/tensors, format=(string)static, "
                     "framerate=(fraction)0/1, num_tensors=(int)2, "
                     f"dimensions=(string){in_dim}.{classes}, "
                     "types=(string)float32.float32"),
        "total_samples": n,
        "sample_size": (in_dim + classes) * 4,
    }
    jpath = tmp_path / "train.json"
    jpath.write_text(json.dumps(index))
    return data, jpath, xs, ys


def _write_frames(tmp_path, n=16):
    """n seeded 32x32x3 uint8 frames with int32 labels in 0..3."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (n, 1)).astype(np.int32)
    data = tmp_path / "frames.data"
    with open(data, "wb") as f:
        for x, y in zip(frames, labels):
            f.write(x.tobytes() + y.tobytes())
    jpath = tmp_path / "frames.json"
    jpath.write_text(json.dumps({
        "gst_caps": ("other/tensors, format=(string)static, "
                     "framerate=(fraction)0/1, num_tensors=(int)2, "
                     "dimensions=(string)3:32:32.1, "
                     "types=(string)uint8.int32"),
        "total_samples": n, "sample_size": 32 * 32 * 3 + 4}))
    return data, jpath, frames, labels


def _samples(pipe):
    return [[np.asarray(c.host()).tobytes() for c in b.chunks]
            for b in pipe["out"].buffers]


# -- datarepo -----------------------------------------------------------------

@pytest.mark.parametrize("props", [
    "is-shuffle=false epochs=1",
    "is-shuffle=false epochs=2 start-sample-index=2 stop-sample-index=4",
    "is-shuffle=true epochs=3",
    "is-shuffle=true epochs=2 start-sample-index=3 stop-sample-index=8",
    "is-shuffle=false epochs=1 tensors-sequence=1,0",
])
def test_datareposrc_emits_the_jax_samples(tmp_path, props):
    data, jpath, _, _ = _write_dataset(tmp_path, n=10)
    desc = f"datareposrc location={data} json={jpath} {props} ! appsink name=out"
    ours, theirs = pt.parse_launch(desc), nt.parse_launch(desc)
    ours.run(timeout=30)
    theirs.run(timeout=30)
    assert _samples(ours) == _samples(theirs)
    assert len(_samples(ours)) > 0


def test_datareposrc_reads_samples(tmp_path):
    data, jpath, xs, ys = _write_dataset(tmp_path, n=10)
    pipe = pt.parse_launch(
        f'datareposrc location={data} json={jpath} is-shuffle=false '
        'epochs=1 ! appsink name=out')
    pipe.run(timeout=30)
    bufs = pipe["out"].buffers
    assert len(bufs) == 10
    np.testing.assert_array_equal(bufs[0].chunks[0].host(), xs[0])
    np.testing.assert_array_equal(bufs[0].chunks[1].host(), ys[0])


def test_datareposink_writes_the_jax_files(tmp_path):
    """datareposrc ! datareposink in each package: the data files and
    the JSON indexes are byte-equal, and the copy reads back."""
    data, jpath, xs, _ = _write_dataset(tmp_path, n=6)
    out = {}
    for name, pkg in (("port", pt), ("jax", nt)):
        d, j = tmp_path / f"{name}.data", tmp_path / f"{name}.json"
        pipe = pkg.parse_launch(
            f"datareposrc location={data} json={jpath} is-shuffle=false "
            f"epochs=1 ! datareposink location={d} json={j}")
        pipe.run(timeout=30)
        pipe.stop()
        out[name] = (d.read_bytes(), j.read_bytes())
    assert out["port"] == out["jax"]
    index = json.loads(out["port"][1])
    assert index["total_samples"] == 6
    assert index["sample_size"] == (8 + 4) * 4
    pipe = pt.parse_launch(
        f"datareposrc location={tmp_path / 'port.data'} "
        f"json={tmp_path / 'port.json'} is-shuffle=false epochs=1 "
        "! appsink name=out")
    pipe.run(timeout=30)
    np.testing.assert_array_equal(pipe["out"].buffers[0].chunks[0].host(),
                                  xs[0])


def test_datarepo_bfloat16_round_trips_on_its_bits(tmp_path):
    """A bfloat16 column (numpy has none) reads as a CPU torch tensor
    whose bits are the JAX element's (ml_dtypes), and datareposink
    writes those bits back unchanged."""
    bits = np.random.default_rng(2).integers(
        0, 1 << 15, (5, 6), dtype=np.uint16)
    data = tmp_path / "bf.data"
    data.write_bytes(bits.tobytes())
    jpath = tmp_path / "bf.json"
    jpath.write_text(json.dumps({
        "gst_caps": ("other/tensors, format=(string)static, "
                     "framerate=(fraction)0/1, num_tensors=(int)1, "
                     "dimensions=(string)6, types=(string)bfloat16"),
        "total_samples": 5, "sample_size": 12}))
    desc = (f"datareposrc location={data} json={jpath} is-shuffle=false "
            "epochs=1 ! appsink name=out")
    ours, theirs = pt.parse_launch(desc), nt.parse_launch(desc)
    ours.run(timeout=30)
    theirs.run(timeout=30)
    got = [b.chunks[0].host() for b in ours["out"].buffers]
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert [g.view(torch.int16).numpy().tobytes() for g in got] == \
        [np.asarray(b.chunks[0].host()).view(np.uint16).tobytes()
         for b in theirs["out"].buffers] == [r.tobytes() for r in bits]
    copy = tmp_path / "copy.data"
    pipe = pt.parse_launch(
        f"datareposrc location={data} json={jpath} is-shuffle=false "
        f"epochs=1 ! datareposink location={copy} json={tmp_path / 'c.json'}")
    pipe.run(timeout=30)
    pipe.stop()
    assert copy.read_bytes() == data.read_bytes()


# -- the MLP trainer against the JAX trainer ----------------------------------

def _jax_init_path(tmp_path, name, **kw):
    """The JAX zoo model's seed-0 params, converted and written with the
    port's save_params: the port trainer's model-load-path."""
    _, params, _, _ = jax_zoo.build(name, **kw)
    host = jax.device_get(params)
    sd = (convert.mlp_params_from_jax(host) if name == "mlp"
          else convert.vit_params_from_jax(host))
    path = str(tmp_path / f"{name}-init")
    save_params(path, sd)
    return path


def _trainer_line(data, jpath, model, framework, epochs, train, val,
                  extra=""):
    return (f"datareposrc location={data} json={jpath} is-shuffle=false "
            f"epochs={epochs} ! tensor_trainer name=t "
            f'framework={framework} model-config="{model}" '
            f"num-training-samples={train} num-validation-samples={val} "
            f"epochs={epochs} num-inputs=1 num-labels=1 {extra} "
            "! appsink name=out")


def _records(pipe):
    return np.stack([b.chunks[0].host() for b in pipe["out"].buffers])


def test_mlp_trainer_records_match_the_jax_trainer(tmp_path):
    """20 epochs of Adam (lr 0.05) on tests/test_training.py's dataset
    from the same f32 weights: every [loss, acc, vloss, vacc] record
    within 1e-4 relative + 1e-5 absolute of the JAX trainer's (f32 sums
    in other orders, compounded over 20 updates), accuracies equal."""
    data, jpath, _, _ = _write_dataset(tmp_path)
    init = _jax_init_path(tmp_path, "mlp", in_dim="8", hidden="16",
                          out_dim="4", dtype="float32")
    ours = pt.parse_launch(_trainer_line(
        data, jpath, MLP, "torch-cuda accelerator=true:cpu", 20, 24, 8,
        f"model-load-path={init}"))
    theirs = nt.parse_launch(_trainer_line(data, jpath, MLP, "jax", 20,
                                           24, 8))
    ours.run(timeout=300)
    theirs.run(timeout=300)
    got, want = _records(ours), _records(theirs)
    assert got.shape == want.shape == (21, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the same counts of right answers (24 and 8 samples): the
    # accuracies differ at most by the rounding of one f32 division
    np.testing.assert_array_equal(np.round(got[:, 1] * 24),
                                  np.round(want[:, 1] * 24))
    np.testing.assert_array_equal(np.round(got[:, 3] * 8),
                                  np.round(want[:, 3] * 8))
    assert got[-1, 0] < got[0, 0] and got[-1, 1] >= 0.5


def test_trainer_snapshot_matches_the_jax_trainers(tmp_path):
    """After 3 epochs each trainer's snapshot blob: the same epoch and
    status (the records test's 1e-4 relative + 1e-5 absolute), and
    Adam's step count and
    moments: the port's ``exp_avg`` and ``exp_avg_sq`` against optax's
    ``mu`` and ``nu`` (same names and layouts for the MLP), every element
    within 1e-4 of the tensor's largest |moment| (f32 gradients in other
    summation orders, three steps; 9.5e-6 measured)."""
    import pickle
    from nnstreamer_tpu.checkpoint import SnapshotStore as NtStore
    from nnstreamer_tpu_torch.checkpoint import SnapshotStore
    data, jpath, _, _ = _write_dataset(tmp_path)
    init = _jax_init_path(tmp_path, "mlp", in_dim="8", hidden="16",
                          out_dim="4", dtype="float32")
    blobs = []
    for pkg, fw, store in (
            (pt, f"torch-cuda accelerator=true:cpu model-load-path={init}",
             SnapshotStore),
            (nt, "jax", NtStore)):
        ckpt = str(tmp_path / f"ckpt-{pkg.__name__}")
        pipe = pkg.parse_launch(_trainer_line(data, jpath, MLP, fw, 3, 32,
                                              0))
        pipe.start()
        pipe.wait_eos(120)
        pipe.preempt(2.0, ckpt)
        snap = store(ckpt).latest()
        with open(os.path.join(snap, "elements", "t.blob"), "rb") as f:
            blobs.append(pickle.loads(f.read()))
    ours, theirs = blobs
    assert ours["epoch"] == theirs["epoch"] == 3
    assert sorted(ours["status"]) == sorted(theirs["status"])
    for k, v in theirs["status"].items():
        assert ours["status"][k] == pytest.approx(v, rel=1e-4, abs=1e-5)
    adam = theirs["opt_state"][0]
    names = ["w1", "b1", "w2", "b2"]  # the port MLP's parameter order
    for i, name in enumerate(names):
        st = ours["opt_state"]["state"][i]
        assert int(st["step"]) == int(adam.count) == 3
        for got, want in ((st["exp_avg"], adam.mu[name]),
                          (st["exp_avg_sq"], adam.nu[name])):
            want = np.asarray(want)
            assert got.shape == want.shape
            assert np.abs(got.numpy() - want).max() \
                <= 1e-4 * np.abs(want).max()


def test_trainer_learns_and_saves(tmp_path):
    data, jpath, _, _ = _write_dataset(tmp_path, n=32)
    save = tmp_path / "model_out"
    pipe = pt.parse_launch(_trainer_line(
        data, jpath, "zoo://mlp?in_dim=8&hidden=16&out_dim=4&lr=0.05",
        "torch-cuda accelerator=true:cpu", 20, 24, 8,
        f"model-save-path={save}"))
    messages = []
    pipe.run(timeout=300)
    messages = [m for m in pipe.bus.drain() if m.kind == "trainer-epoch"]
    pipe.stop()
    stats = pipe["out"].buffers
    assert len(stats) >= 20  # one per epoch (+ completion)
    assert [int(b.pts) for b in stats[:20]] == list(range(1, 21))
    assert [m.data["epoch"] for m in messages][:20] == list(range(1, 21))
    first, last = stats[0].chunks[0].host(), stats[-1].chunks[0].host()
    assert first.dtype == np.float64 and first.shape == (4,)
    assert last[0] < first[0]  # training loss decreased
    assert last[1] >= 0.5      # learnable toy task fits
    assert (save / "params").is_file()  # the state_dict file
    sd = restore_params(str(save))
    assert sorted(sd) == ["b1", "b2", "w1", "w2"]


def test_trainer_resume_from_checkpoint(tmp_path):
    """tests/test_training.py's case from its own weights (the JAX zoo's
    bf16 MLP init, converted and read through model-load-path): three
    epochs, save, three more from the saved weights with a fresh Adam;
    the second run starts where the first ended and ends lower."""
    data, jpath, _, _ = _write_dataset(tmp_path, n=16)
    init = _jax_init_path(tmp_path, "mlp", in_dim="8", hidden="16",
                          out_dim="4")
    save = tmp_path / "ckpt"
    model = "zoo://mlp?in_dim=8&hidden=16&out_dim=4&lr=0.05"
    fw = "torch-cuda accelerator=true:cpu"
    pipe = pt.parse_launch(_trainer_line(
        data, jpath, model, fw, 3, 16, 0,
        f"model-save-path={save} model-load-path={init}"))
    pipe.run(timeout=300)
    pipe.stop()
    first_a = pipe["out"].buffers[0].chunks[0].host()[0]
    loss_a = pipe["out"].buffers[-1].chunks[0].host()[0]
    pipe = pt.parse_launch(_trainer_line(
        data, jpath, model, fw, 3, 16, 0,
        f"model-save-path={save} model-load-path={save}"))
    pipe.run(timeout=300)
    pipe.stop()
    first_b = pipe["out"].buffers[0].chunks[0].host()[0]
    loss_b = pipe["out"].buffers[-1].chunks[0].host()[0]
    assert first_b < first_a  # started from the trained weights
    assert loss_b < loss_a  # continued from the saved params


# -- the ViT: gradients, then the epoch records -------------------------------

def test_vit_loss_and_gradients_match_jax():
    """One batch of 8 frames through the tiny ViT from the same weights,
    bf16 compute: loss within 1e-3 relative; the gradient of every
    parameter, all concatenated, at cosine >= 0.999 with JAX's, and
    every element within 2 % of the largest |gradient| (bf16 rounding of
    the forward and backward; 0.99 % measured). The key projection's
    bias has a zero gradient in exact arithmetic (softmax ignores a
    per-query constant): both packages give rounding noise there, below
    1e-3 of the largest gradient."""
    loss_j, params, _ = jax_trainer._zoo_classifier_trainer(
        "vit", **TINY_VIT)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (8, 1)).astype(np.int32)
    (jl, ja), jg = jax.value_and_grad(loss_j, has_aux=True)(
        params, [jnp.asarray(x)], [jnp.asarray(y)])
    loss_p, module, _ = torch_cuda_trainer._zoo_classifier_trainer(
        "vit", **TINY_VIT)
    module.load_state_dict(convert.vit_params_from_jax(
        jax.device_get(params)))
    pl, pa = loss_p(module, [torch.from_numpy(x)], [torch.from_numpy(y)])
    pl.backward()
    assert float(pl.detach()) == pytest.approx(float(jl), rel=1e-3)
    assert float(pa) == float(ja)
    want = convert.vit_params_from_jax(jax.device_get(jg))
    names = [n for n, _ in module.named_parameters()]
    assert sorted(names) == sorted(want)
    a = np.concatenate([want[n].numpy().ravel() for n in names])
    b = np.concatenate([p.grad.numpy().ravel()
                        for _, p in module.named_parameters()])
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    gmax = np.abs(a).max()
    assert cos >= 0.999
    assert np.abs(a - b).max() <= 0.02 * gmax
    for n, p in module.named_parameters():
        if n.endswith("attn.key.bias"):
            assert np.abs(want[n].numpy()).max() <= 1e-3 * gmax
            assert np.abs(p.grad.numpy()).max() <= 1e-3 * gmax


def test_vit_trainer_records_match_the_jax_trainer(tmp_path):
    """Four epochs of the tiny ViT (Adam, lr 1e-3, 12 training and 4
    validation frames) from the JAX init: training and validation
    losses within 1e-2 relative of the JAX trainer's (bf16 compute;
    Adam's first steps are ~lr·sign(g), so a gradient near zero can
    flip an element — the records, not the weights, are the oracle)."""
    data, jpath, _, _ = _write_frames(tmp_path)
    model = ("zoo://vit?" + "&".join(f"{k}={v}" for k, v in TINY_VIT.items())
             + "&lr=1e-3")
    init = _jax_init_path(tmp_path, "vit", **TINY_VIT)
    ours = pt.parse_launch(_trainer_line(
        data, jpath, model, "torch-cuda accelerator=true:cpu", 4, 12, 4,
        f"model-load-path={init}"))
    theirs = nt.parse_launch(_trainer_line(data, jpath, model, "jax", 4,
                                           12, 4))
    ours.run(timeout=300)
    theirs.run(timeout=300)
    got, want = _records(ours), _records(theirs)
    assert got.shape == want.shape == (5, 4)
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-2)


# -- the GPT ------------------------------------------------------------------

def test_gpt_loss_matches_jax():
    """``transformer.loss_fn`` from the same JAX init (bf16 weights and
    compute) on 4 seeded 9-token rows: within 1e-3 relative."""
    from nnstreamer_tpu.models import transformer as jtf
    from nnstreamer_tpu_torch.models import transformer as ptf
    kw = dict(vocab=32, d_model=16, n_heads=2, n_layers=1)
    jc, pc = jtf.GPTConfig(**kw), ptf.GPTConfig(**kw)
    params = jtf.init_params(jc, jax.random.PRNGKey(0))
    module = ptf.GPT(pc)
    module.load_state_dict(convert.gpt_params_from_jax(
        jax.device_get(params)))
    toks = np.random.default_rng(4).integers(0, 32, (4, 9)).astype(np.int32)
    want = float(jtf.loss_fn(params, jnp.asarray(toks), jc))
    got = float(ptf.loss_fn(module, torch.from_numpy(toks), pc))
    assert got == pytest.approx(want, rel=1e-3)


GPT_TRAINER_PY = """\
import torch
from nnstreamer_tpu_torch.models import transformer as tfm
CFG = tfm.GPTConfig(vocab=32, d_model=16, n_heads=2, n_layers=1)
def get_trainer():
    params = tfm.init_params(CFG, torch.Generator().manual_seed(0))
    def loss_fn(p, inputs, labels):
        return tfm.loss_fn(p, inputs[0], CFG), torch.zeros(())
    return loss_fn, params, lambda ps: torch.optim.Adam(ps, lr=5e-2)
"""


def test_train_gpt_in_pipeline_then_serve_with_llm(tmp_path):
    """tests/test_training.py:210's loop in the port: datareposrc
    streams token sequences into tensor_trainer (GPT next-token loss
    from a model-config file), the checkpoint saves as a state_dict, and
    the llm filter serves it through zoo://gpt?params_dir=...; the
    memorized "+1 each step" continues."""
    from nnstreamer_tpu_torch.filters.base import (Accelerator,
                                                   FilterProperties)
    from nnstreamer_tpu_torch.filters.registry import find_filter
    cfg_py = tmp_path / "gpt_trainer.py"
    cfg_py.write_text(GPT_TRAINER_PY)
    n, t = 24, 8
    seqs = np.stack([(np.arange(t + 1) + i) % 32 for i in range(n)])
    data = tmp_path / "tokens.data"
    with open(data, "wb") as f:
        for s in seqs:
            f.write(s.astype(np.int32).tobytes()
                    + np.zeros(1, np.float32).tobytes())
    jpath = tmp_path / "tokens.json"
    jpath.write_text(json.dumps({
        "gst_caps": ("other/tensors, format=(string)static, "
                     "framerate=(fraction)0/1, num_tensors=(int)2, "
                     f"dimensions=(string){t + 1}.1, "
                     "types=(string)int32.float32"),
        "total_samples": n, "sample_size": (t + 1) * 4 + 4}))
    ckpt = str(tmp_path / "gpt-trained")
    pipe = pt.parse_launch(_trainer_line(
        data, jpath, str(cfg_py), "torch-cuda accelerator=true:cpu", 4, n,
        0, f"model-save-path={ckpt}"))
    pipe.run(timeout=300)
    losses = [float(b.chunks[0].host()[0]) for b in pipe["out"].buffers]
    assert len(losses) >= 4
    assert losses[-1] < losses[0], losses
    assert os.path.isfile(os.path.join(ckpt, "params"))

    fw = find_filter("llm")()
    fw.open(FilterProperties(
        model_files=("zoo://gpt?vocab=32&d_model=16&n_heads=2&n_layers=1"
                     f"&params_dir={ckpt}",),
        custom_properties="max_tokens:6,max_len:32",
        accelerators=(Accelerator.CPU,)))
    toks = fw.invoke([np.array([4, 5, 6], np.int32)])[0]
    fw.close()
    assert np.asarray(toks).shape == (6,)
    assert toks[0] == 7, toks


# -- refusals and divergences (ROADMAP.md §C) ---------------------------------

def _start_trainer(tmp_path, model, extra="accelerator=true:cpu"):
    data, jpath, _, _ = _write_dataset(tmp_path, n=4)
    pipe = pt.parse_launch(_trainer_line(data, jpath, model,
                                         f"torch-cuda {extra}", 1, 4, 0))
    try:
        pipe.start()
    finally:
        pipe.stop()


def test_vit_with_the_hand_attention_is_refused_for_training(tmp_path):
    """The hand attention kernel has no backward: zoo://vit?attn=pallas
    is refused at create, not trained through the plain attention (the
    JAX reference fails at its first step on its own device and, on the
    CPU, trains through reference_attention)."""
    model = "zoo://vit?" + "&".join(
        f"{k}={v}" for k, v in TINY_VIT.items()) + "&attn=pallas"
    with pytest.raises(pt.NotPortedError, match="no backward"):
        _start_trainer(tmp_path, model)


def test_mobilenet_training_is_refused(tmp_path):
    """The JAX trainer's Adam updates BatchNorm's batch_stats as
    parameters (zoo.build returns the whole variables dict); the port
    keeps them as buffers, so it refuses rather than train other
    leaves."""
    with pytest.raises(pt.NotPortedError, match="buffers"):
        _start_trainer(tmp_path, "zoo://mobilenet_v2?width=0.35&size=96")


@pytest.mark.parametrize("extra", ["mesh=4x1x2", "rules=gpt",
                                   "mesh=4x1x2 rules=gpt"])
def test_trainer_mesh_and_rules_are_refused(tmp_path, extra):
    """Mesh mode is ported. On one host device a 4x1x2 mesh is refused
    at start with the JAX package's error, a rule table without a mesh
    changes nothing (as in JAX), and ``mesh=auto`` with the CPU opt-out
    resolves to 1x1x1: a one-rank world, stopped again when the trainer
    is destroyed."""
    from nnstreamer_tpu_torch.parallel import mesh as pmesh, world
    if "mesh" in extra:
        with pytest.raises(ValueError, match="needs 8 devices, have 1"):
            _start_trainer(tmp_path, MLP, f"accelerator=true:cpu {extra}")
    else:
        _start_trainer(tmp_path, MLP, f"accelerator=true:cpu {extra}")
    assert not world.started()
    trainer = find_trainer("torch-cuda")()
    from nnstreamer_tpu_torch.trainers import TrainerProperties
    from nnstreamer_tpu_torch.filters.base import Accelerator
    trainer.create(TrainerProperties(model_config=MLP, mesh="auto",
                                     accelerators=(Accelerator.CPU,)))
    try:
        assert pmesh.factorization(trainer._mesh) == (1, 1, 1)
        assert world.started() and world.world().size == 1
    finally:
        trainer.destroy()
    assert not world.started()


def test_trainer_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    """No accelerator property: the trainer wants cuda:0 and raises at
    start without CUDA (never a silent CPU fallback); true:cpu and
    false train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _start_trainer(tmp_path, MLP, "")
    for opt in ("accelerator=true:cpu", "accelerator=false"):
        data, jpath, _, _ = _write_dataset(tmp_path, n=4)
        pipe = pt.parse_launch(_trainer_line(data, jpath, MLP,
                                             f"torch-cuda {opt}", 1, 4, 0))
        pipe.start()
        try:
            assert pipe.wait_eos(60)
            assert pipe["t"].fw.device == torch.device("cpu")
        finally:
            pipe.stop()


def test_restore_params_refuses_an_orbax_checkpoint(tmp_path):
    """An orbax tree the JAX package saved at <path>/params is refused
    by name; the port reads its own state_dict files only."""
    from nnstreamer_tpu.trainers.checkpoint import save_params as nt_save
    nt_save(str(tmp_path / "jax"), {"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="orbax"):
        restore_params(str(tmp_path / "jax"))
    _, module, _, _ = pt.models.zoo.build("mlp", in_dim="8", hidden="16",
                                          out_dim="4")
    with pytest.raises(ValueError, match="orbax"):
        pt.models.zoo.build("mlp", in_dim="8", hidden="16", out_dim="4",
                            params_dir=str(tmp_path / "jax"))


def test_params_dir_loads_saved_weights_into_any_zoo_model(tmp_path):
    """zoo://<name>?params_dir= reads <dir>/params into the built
    module: the seed-1 weights come back under a seed-0 build."""
    _, seed1, _, _ = pt.models.zoo.build("mlp", in_dim="8", hidden="16",
                                         out_dim="4", seed="1")
    save_params(str(tmp_path / "ckpt"), seed1)
    _, loaded, _, _ = pt.models.zoo.build(
        "mlp", in_dim="8", hidden="16", out_dim="4",
        params_dir=str(tmp_path / "ckpt"))
    for (n, a), (_, b) in zip(seed1.state_dict().items(),
                              loaded.state_dict().items()):
        assert torch.equal(a, b), n


def test_new_modules_import_no_jax():
    """The checkpoint layer, the trainers, the trainer/datarepo/repo
    elements and fault/preempt.py import nothing of JAX, flax, optax,
    orbax or the JAX package; imported in a fresh interpreter."""
    code = ("import sys; import nnstreamer_tpu_torch, "
            "nnstreamer_tpu_torch.checkpoint, "
            "nnstreamer_tpu_torch.checkpoint.state, "
            "nnstreamer_tpu_torch.checkpoint.store, "
            "nnstreamer_tpu_torch.fault.preempt, "
            "nnstreamer_tpu_torch.trainers, "
            "nnstreamer_tpu_torch.trainers.base, "
            "nnstreamer_tpu_torch.trainers.checkpoint, "
            "nnstreamer_tpu_torch.trainers.torch_cuda_trainer, "
            "nnstreamer_tpu_torch.elements.trainer, "
            "nnstreamer_tpu_torch.elements.datarepo, "
            "nnstreamer_tpu_torch.elements.repo; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_dtypes', "
            "'nnstreamer_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    import re
    pattern = re.compile(r"^\s*(from|import)\s+(jax|flax|optax|orbax|"
                         r"nnstreamer_tpu)(\.|\s|$)", re.M)
    sources = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, files in os.walk(
            os.path.join(ROOT, "nnstreamer_tpu_torch"))
        for f in files if f.endswith(".py")]
    bad = [p for p in sources if pattern.search(open(p).read())]
    assert not bad, bad
