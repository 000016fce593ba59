"""Mesh mode's core on ``torch.distributed`` (nnstreamer_tpu_torch/parallel/)
against the JAX package's ``parallel/``, on the CPU.

Mirrors tests/test_parallel.py: mesh factoring, the GPT rule table, ring
and Ulysses attention, the sharded forward and train step, the dryrun
and the device-count guard. The port runs on an 8-rank gloo world (one
per file: the module fixture sets 8 host devices and holds the world
until the last test; xdist's ``--dist loadfile`` keeps the file on one
worker), the JAX package on conftest.py's 8 virtual CPU devices. Inputs
come from numpy seeds and go through both packages; JAX's GPT weights
are carried over with ``models.convert.gpt_params_from_jax``.

Tolerances (each compare states its own): ring and Ulysses against
JAX's ring and the port's ``dense_reference`` at JAX's own 2e-4; the
sharded forward at 2e-4; the sharded train step's five losses at
tests/test_torch_training.py's Adam tolerance (rtol 1e-4, atol 1e-5)
against JAX's sharded step on the same weights and batch, in float32
and AdamW at optax's defaults (weight decay 1e-4).
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from nnstreamer_tpu.models import transformer as J
from nnstreamer_tpu.parallel import GPT_RULES as J_RULES
from nnstreamer_tpu.parallel import pspec_tree as j_pspec_tree
from nnstreamer_tpu.parallel.mesh import best_mesh as j_best_mesh
from nnstreamer_tpu.parallel.mesh import make_mesh as j_make_mesh
from nnstreamer_tpu.parallel.ring import ring_attention_sharded as j_ring
from nnstreamer_tpu.parallel.sharding import shard_params as j_shard_params
from nnstreamer_tpu_torch.models import transformer as T
from nnstreamer_tpu_torch.models.convert import gpt_params_from_jax
from nnstreamer_tpu_torch.parallel import GPT_RULES, pspec_tree, world
from nnstreamer_tpu_torch.parallel.mesh import (best_mesh, factorization,
                                                make_mesh, set_host_devices,
                                                shape_of)
from nnstreamer_tpu_torch.parallel.ring import (dense_reference,
                                                ring_attention_sharded)
from nnstreamer_tpu_torch.parallel.sharding import P, shard_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def mesh_world():
    """One 8-rank world for the whole file (the followers also find
    tests/torch_mesh_commands.py, which imports no JAX)."""
    here = os.path.dirname(os.path.abspath(__file__))
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = here + (os.pathsep + saved if saved else "")
    set_host_devices(8)
    world.retain()
    yield world.world()
    world.shutdown()
    set_host_devices(None)
    if saved is None:
        os.environ.pop("PYTHONPATH", None)
    else:
        os.environ["PYTHONPATH"] = saved


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _gpt(n_layers=2, dtype="float32"):
    """The JAX GPT's params and the port's module with them."""
    jcfg = J.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=n_layers,
                       d_ff=64, dtype=getattr(jnp, dtype))
    jparams = J.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = T.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=n_layers,
                       d_ff=64, dtype=getattr(torch, dtype))
    module = T.GPT(tcfg)
    module.load_state_dict(gpt_params_from_jax(jparams))
    return jcfg, jparams, tcfg, module


def _followers_ran(before):
    """Every follower ran a command since ``before``."""
    after = world.world().executed
    return all(a > b for a, b in zip(after[1:], before[1:]))


def test_mesh_factoring():
    assert shape_of(best_mesh(8)) == {"data": 2, "seq": 2, "model": 2}
    assert shape_of(best_mesh(4)) == {"data": 1, "seq": 2, "model": 2}
    assert shape_of(best_mesh(1)) == {"data": 1, "seq": 1, "model": 1}
    for n in (8, 4, 1):
        assert factorization(best_mesh(n)) == \
            tuple(j_best_mesh(n).shape.values())
    # one DeviceMesh a shape, shared by every user
    assert best_mesh(8) is make_mesh((2, 2, 2))
    with pytest.raises(ValueError, match=r"needs 16 devices, have 8"):
        make_mesh((4, 4, 1))


def test_gpt_pspecs():
    _, jparams, tcfg, module = _gpt(n_layers=1)
    mesh = best_mesh(8)
    specs = pspec_tree(module, GPT_RULES, mesh)
    assert specs["layers/0/wq"] == P(None, "model")
    assert specs["layers/0/wo"] == P("model", None)
    assert specs["layers/0/ln1"] == P()
    assert specs["embed"] == P("model", None)
    placed = shard_params(module, GPT_RULES, mesh)
    from torch.distributed.tensor import DTensor, Shard
    wq = placed.layers[0].wq
    assert isinstance(wq, DTensor) and wq.placements == (Shard(1),)
    assert wq.to_local().shape == (32, 16)  # its model-axis shard
    assert not isinstance(placed.layers[0].ln1, DTensor)


def _jax_named(params):
    """{path: PartitionSpec} of a JAX pspec tree."""
    from nnstreamer_tpu.parallel.sharding import _path_str
    tree = j_pspec_tree(params, J_RULES, j_best_mesh(8))
    return {_path_str(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


@pytest.mark.parametrize("name,kwargs", [
    ("gpt", dict(vocab="64", d_model="32", n_heads="4", n_layers="2")),
    ("mlp", {}),
    ("vit", dict(size="32", patch="8", d_model="32", layers="2",
                 heads="2", classes="10")),
])
def test_pspec_tree_matches_jax_for_every_parameter(name, kwargs):
    """Every parameter of the JAX tree gets the spec JAX gives it under
    rules:gpt, by its JAX path, and the port places the dims that spec
    shards: the same extent of the JAX tensor and of the port's."""
    from nnstreamer_tpu.models import zoo as jzoo
    from nnstreamer_tpu_torch.models import zoo as tzoo
    from nnstreamer_tpu_torch.parallel.sharding import (jax_path,
                                                        placement_tree)
    _, jparams, _, _ = jzoo.build(name, **kwargs)
    _, module, _, _ = tzoo.build(name, **kwargs)
    want = _jax_named(jparams)
    got = pspec_tree(module, GPT_RULES, best_mesh(8))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), path
    from nnstreamer_tpu.parallel.sharding import _path_str
    jshapes = {_path_str(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(jparams)[0]}
    places = placement_tree(module, GPT_RULES, best_mesh(8))
    tensors = dict(module.named_parameters())
    tensors.update(dict(module.named_buffers()))
    for tname, pl in places.items():
        path, dim_map = jax_path(module, tname)
        spec = want[path]
        for axis, p in zip(("data", "seq", "model"), pl):
            if axis not in tuple(spec):
                assert p.is_replicate(), (tname, axis)
                continue
            jd = tuple(spec).index(axis)
            td = dim_map[jd] if dim_map is not None else jd
            assert p.is_shard(td), (tname, axis, p)
            if dim_map is None:
                assert tensors[tname].shape[td] == jshapes[path][jd]


def test_ring_attention_matches_dense():
    """Ring attention on a 4-way seq mesh: the port's against its dense
    reference and against JAX's ring on the same inputs (2e-4)."""
    q, k, v = _qkv(0, (2, 32, 4, 16))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = list(world.world().executed)
    out = ring_attention_sharded(tq, tk, tv, make_mesh((1, 4, 1)),
                                 "data", "seq", "model")
    assert _followers_ran(before[:4])
    np.testing.assert_allclose(out.numpy(),
                               dense_reference(tq, tk, tv).numpy(), **TOL)
    jmesh = j_make_mesh((1, 4, 1))
    with jmesh:
        want = jax.jit(lambda q, k, v: j_ring(
            q, k, v, jmesh, "data", "seq", "model"))(q, k, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_ring_attention_full_mesh_with_heads_sharded():
    q, k, v = _qkv(1, (2, 16, 4, 8))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = ring_attention_sharded(tq, tk, tv, make_mesh((2, 2, 2)),
                                 "data", "seq", "model")
    np.testing.assert_allclose(out.numpy(),
                               dense_reference(tq, tk, tv).numpy(), **TOL)
    want = j_ring(q, k, v, j_make_mesh((2, 2, 2)), "data", "seq", "model")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_sharded_train_step_loss_decreases():
    """Five AdamW steps on the 2x2x2 mesh (ring attention over seq,
    Megatron TP over model, the batch over data): the losses fall, the
    state counts five steps and stays placed on the mesh, and each loss
    is JAX's sharded step's on the same weights and batch."""
    import optax
    from nnstreamer_tpu.parallel.train import (
        create_train_state as j_create, make_train_step as j_make_step,
        shard_batch as j_shard_batch)
    from torch.distributed.tensor import DTensor
    from nnstreamer_tpu_torch.parallel.train import (create_train_state,
                                                     make_train_step,
                                                     shard_batch)
    jcfg, jparams, tcfg, module = _gpt()
    batch = np.random.default_rng(2).integers(0, 64, (4, 17)).astype(np.int32)

    jmesh = j_best_mesh(8)
    jcfg_m = J.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, dtype=jnp.float32, mesh=jmesh,
                         seq_axis="seq")
    opt = optax.adamw(1e-2)
    jstate = j_create(jparams, opt, jmesh, J_RULES)
    jstep = j_make_step(lambda p, b: J.loss_fn(p, b, jcfg_m), opt)
    jb = j_shard_batch(jnp.asarray(batch), jmesh, JP("data", None))
    want = []
    for _ in range(5):
        jstate, loss = jstep(jstate, jb)
        want.append(float(loss))

    mesh = best_mesh(8)
    cfg = T.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                      dtype=torch.float32, mesh=mesh, seq_axis="seq")
    optimizer = functools.partial(torch.optim.AdamW, lr=1e-2,
                                  weight_decay=1e-4)
    state = create_train_state(module, optimizer, mesh, GPT_RULES)
    step = make_train_step(functools.partial(T.loss_fn, cfg=cfg))
    tb = shard_batch(torch.from_numpy(batch), mesh, P("data", None))
    before = list(world.world().executed)
    got = []
    for _ in range(5):
        state, loss = step(state, tb)
        got.append(float(loss))
    assert _followers_ran(before)
    assert got[-1] < got[0]
    assert state.step == 5
    # params stayed placed: wq is a DTensor sharded over the model axis
    assert isinstance(state.params.layers[0].wq, DTensor)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _sharded_forward_case(scheme):
    """tp/sp sharded forward == unsharded forward (2e-4), and == JAX's
    sharded forward on the same weights (2e-4)."""
    jcfg, jparams, tcfg, module = _gpt()
    tokens = np.random.default_rng(1).integers(0, 64, (2, 16)) \
        .astype(np.int32)
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        ref = T.forward(module, tt, tcfg)
    mesh = best_mesh(8)
    cfg2 = T.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, dtype=torch.float32, mesh=mesh,
                       seq_axis="seq", seq_scheme=scheme)
    out = T.forward(shard_params(module, GPT_RULES, mesh), tt, cfg2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    jmesh = j_best_mesh(8)
    jcfg2 = J.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                        d_ff=64, dtype=jnp.float32, mesh=jmesh,
                        seq_axis="seq", seq_scheme=scheme)
    want = jax.jit(lambda p, t: J.forward(p, t, jcfg2))(
        j_shard_params(jparams, J_RULES, jmesh), jnp.asarray(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_sharded_forward_matches_single_device():
    """tp/sp sharded forward (ring attention over seq) == unsharded."""
    _sharded_forward_case("ring")


def test_graft_entry():
    """The port's forward at the graft entry's config (vocab 1024,
    d_model 256, 8 heads, 4 layers, tokens [2, 64]): finite logits of
    the JAX entry's shape."""
    import __graft_entry__ as ge
    _, (jparams, jtokens) = ge.entry()
    cfg = T.GPTConfig(vocab=1024, d_model=256, n_heads=8, n_layers=4)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = T.forward(params, torch.from_numpy(np.array(jtokens)), cfg)
    assert tuple(out.shape) == (2, 64, 1024)
    assert torch.isfinite(out).all()


def test_graft_dryrun_multichip(capsys):
    """``parallel.dryrun 8`` in-process on the file's world: the train
    step through ring then Ulysses, and the micro-batched serve round
    (its own asserts: fewer invokes than frames, every client's rows in
    order and equal to the one-device filter)."""
    from nnstreamer_tpu_torch.parallel import dryrun
    loss = dryrun.run(8)
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "mesh dp=2 sp=2 tp=2 seq=ring+ulysses" in out
    assert "row-routing infer ok" in out
    assert world.started() and world.world().size == 8


def test_ulysses_attention_matches_dense():
    """All-to-all sequence parallelism on a 4-way seq mesh: the port's
    against its dense reference and against JAX's dense reference."""
    from nnstreamer_tpu.parallel.ring import dense_reference as j_dense
    from nnstreamer_tpu_torch.parallel.ulysses import \
        ulysses_attention_sharded
    q, k, v = _qkv(1, (2, 32, 8, 16))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = ulysses_attention_sharded(tq, tk, tv, make_mesh((1, 4, 1)),
                                    "data", "seq", "model")
    np.testing.assert_allclose(out.numpy(),
                               dense_reference(tq, tk, tv).numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_dense(q, k, v)),
                               **TOL)


def test_ulysses_attention_with_data_axis():
    """Batch over data x seq sharding together; heads == seq size edge."""
    from nnstreamer_tpu.parallel.ulysses import \
        ulysses_attention_sharded as j_ulysses
    from nnstreamer_tpu_torch.parallel.ulysses import \
        ulysses_attention_sharded
    q, k, v = _qkv(2, (4, 16, 4, 8))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = ulysses_attention_sharded(tq, tk, tv, make_mesh((2, 2, 2)),
                                    "data", "seq", "model")
    np.testing.assert_allclose(out.numpy(),
                               dense_reference(tq, tk, tv).numpy(), **TOL)
    jmesh = j_make_mesh((2, 2, 2))
    with jmesh:
        want = jax.jit(lambda q, k, v: j_ulysses(
            q, k, v, jmesh, "data", "seq", "model"))(q, k, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_ulysses_rejects_indivisible_heads():
    """The local-heads guard raises before any rank runs (the world is
    untouched and serves the next command)."""
    from nnstreamer_tpu_torch.parallel.ulysses import \
        ulysses_attention_sharded
    q = torch.zeros((1, 16, 3, 8))  # 3 heads, 4-way seq axis
    before = list(world.world().executed)
    with pytest.raises(ValueError, match="ring attention"):
        ulysses_attention_sharded(q, q, q, make_mesh((1, 4, 1)),
                                  "data", "seq", "model")
    assert world.world().executed == before
    assert world.world().broken is None


def test_sharded_forward_ulysses_matches_single_device():
    """The scheme is a config knob, not a different model; with 4 heads
    over model 2 and seq 2, both schemes are exact."""
    _sharded_forward_case("ulysses")


def test_ensure_devices_satisfied_in_process():
    """The file's world has 8 ranks, so asking for <= 8 is fine even
    though it long since started."""
    from nnstreamer_tpu_torch.parallel.dryrun import ensure_devices
    ensure_devices(8)  # must not raise


def test_ensure_devices_refuses_after_backend_init():
    """Asking for more devices than the running world has fails loudly,
    naming the fresh-process fallback — and so does changing the count."""
    from nnstreamer_tpu_torch.parallel.dryrun import ensure_devices
    with pytest.raises(RuntimeError, match="fresh process"):
        ensure_devices(64)
    with pytest.raises(RuntimeError, match="fresh process"):
        set_host_devices(64)


def test_ensure_devices_refuses_in_clean_process():
    """End-to-end: a process whose mesh world started with one device
    gets the explicit error from ensure_devices."""
    code = (
        "from nnstreamer_tpu_torch.parallel import mesh, world\n"
        "mesh.set_host_devices(1)\n"
        "mesh.make_mesh((1, 1, 1))\n"
        "from nnstreamer_tpu_torch.parallel.dryrun import ensure_devices\n"
        "try:\n"
        "    ensure_devices(8)\n"
        "except RuntimeError as exc:\n"
        "    assert 'dryrun' in str(exc) and 'fresh process' in str(exc), exc\n"
        "    print('REFUSED')\n"
        "else:\n"
        "    raise SystemExit('ensure_devices silently no-opped')\n"
        "world.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "REFUSED" in out.stdout


def test_a_follower_that_fails_breaks_the_world_and_raises():
    """Rank 3 raises while rank 0 gets through (its model-group partner,
    rank 2, waits on rank 3 in a collective): rank 0 raises with rank 3's
    traceback at once instead of waiting for rank 2, and the next mesh
    command runs on a new world. (Runs last: it restarts the world.)"""
    import time
    import torch_mesh_commands as cmds
    mesh = make_mesh((2, 1, 2))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="raised on rank 3"):
        world.run(cmds.fail_on_rank, 3, mesh)
    assert time.monotonic() - t0 < 60
    assert world.world().broken is None  # a new world, its followers up
    out = world.run(cmds.fail_on_rank, -1, make_mesh((2, 1, 2)))
    assert out == 2.0
