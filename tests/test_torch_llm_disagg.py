"""The port's disaggregated LLM line against the JAX package's, on the CPU.

Mirrors tests/test_llm_disagg.py's ``TestKvWire``, ``TestHandoff`` and
``TestChaosDecodeKill`` (the latter unmarked here: at these widths it
runs in a few seconds), tests/test_checkpoint.py's
``test_llm_stream_snapshot_and_adoption`` and tests/test_analysis.py's
``llm-prefix-cache-lossy-link`` cases, and adds what only a two-package
run shows:

* the KV_XFER link: a JAX ``KvSender`` ships to a port ``KvReceiver``
  and the reverse, and both packages pack the same meta and payload
  bytes for the same stream under every precision;
* a JAX prefill replica ships to a port decode replica, and the reverse,
  and each split emits the monolithic tokens; the port's split emits the
  JAX split's greedy tokens at float32 with the same counters;
* the decode-kill resume (a decode replica closed mid-stream, its
  snapshot restored into a fresh one, the prompt re-shipped) gives the
  JAX package's concatenated stream, and a sampled resume continues the
  straight run (the port seats a re-adopted stream's sampling counter at
  the draws it already took; JAX promises this for greedy streams only);
* ``tensor_serve_src llm-role=`` rides REGISTER and PONG, read by the
  port's router and broker from either package's replica.

The cross-package token checks run both packages on one float32 weight
set (a ``get_lm()`` file each, from a JAX ``init_params`` tree); tokens
compare exactly. Every socket binds port 0 and every wait has its own
bound.
"""
import copy
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.edge import kv as nt_kv
from nnstreamer_tpu.edge import wire as nt_wire
from nnstreamer_tpu.filters.base import FilterProperties as JaxProps
from nnstreamer_tpu.filters.registry import find_filter as jax_find
from nnstreamer_tpu.models import transformer as J
from nnstreamer_tpu_torch.edge import kv as pt_kv
from nnstreamer_tpu_torch.edge import wire as pt_wire
from nnstreamer_tpu_torch.filters import find_filter
from nnstreamer_tpu_torch.filters.base import Accelerator, FilterProperties

ZOO = "zoo://gpt?vocab=64&d_model=32&n_heads=4&n_layers=2"
WAIT_S = 60.0


# -- filters of either package -------------------------------------------------

def mk(custom, model=ZOO):
    f = find_filter("llm")()
    f.open(FilterProperties(model_files=(model,), custom_properties=custom,
                            accelerators=(Accelerator.CPU,)))
    return f


def mk_jax(custom, model):
    f = jax_find("llm")()
    f.open(JaxProps(model_files=(model,), custom_properties=custom))
    return f


def collect(f, prompts, per_stream, timeout=WAIT_S):
    """Submit prompts, return {ctx: [tokens]} once every stream emitted
    ``per_stream`` tokens."""
    out = {}
    done = threading.Event()
    lock = threading.Lock()
    want = len(prompts) * per_stream

    def disp(outs, ctx):
        with lock:
            out.setdefault(ctx, []).append(
                int(np.asarray(outs[0]).ravel()[0]))
            if sum(len(v) for v in out.values()) >= want:
                done.set()

    f.set_async_dispatcher(disp)
    for i, p in enumerate(prompts):
        f.invoke_async([np.asarray(p, np.int32)], ctx=i)
    assert done.wait(timeout), \
        f"timeout: {({k: len(v) for k, v in out.items()})} of {want}"
    return out


def gen(make, custom, prompts, per_stream):
    f = make(custom)
    try:
        return collect(f, prompts, per_stream)
    finally:
        f.close()


def split(make_pre, make_dec, custom, prompts, per_stream):
    """Prompts into a prefill replica that ships to a decode replica:
    -> ({sid: tokens}, prefill stats, decode stats)."""
    dec = make_dec(custom + ",n_parallel:2,role:decode,handoff_port:0")
    out = {}
    lock = threading.Lock()
    done = threading.Event()
    want = len(prompts) * per_stream

    def disp(outs, ctx):
        with lock:
            out.setdefault(ctx, []).append(
                int(np.asarray(outs[0]).ravel()[0]))
            if sum(len(v) for v in out.values()) >= want:
                done.set()

    dec.set_async_dispatcher(disp)
    pre = make_pre(custom + f",role:prefill,handoff:127.0.0.1:"
                   f"{dec.handoff_port}")
    try:
        for p in prompts:
            pre.invoke_async([np.asarray(p, np.int32)], ctx=None)
        assert done.wait(WAIT_S), {k: len(v) for k, v in out.items()}
    finally:
        pre.close()
        dec.close()
    return out, dict(pre.stats.snapshot()), dict(dec.stats.snapshot())


def _sha(p):
    from nnstreamer_tpu_torch.checkpoint.state import token_sha
    return token_sha(np.asarray(p, np.int32))


LM_PY = """
import numpy as np
{imports}

def get_lm():
    z = np.load({npz!r})
    tree = {{k: z[k] for k in ("embed", "head", "ln_f")}}
    tree["layers"] = [{{n: z[f"{{i}}.{{n}}"] for n in
                       ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2")}}
                      for i in range(2)]
    return tree, GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                           dtype={dtype})
"""


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """One float32 weight set as a ``get_lm()`` file for each package:
    {"jax": make_jax, "port": make_port} filter factories."""
    tmp = tmp_path_factory.mktemp("lm")
    jcfg = J.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                       dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jax.device_get(
        J.init_params(jcfg, jax.random.PRNGKey(5))))
    flat = {k: tree[k] for k in ("embed", "head", "ln_f")}
    for i, layer in enumerate(tree["layers"]):
        flat.update({f"{i}.{n}": a for n, a in layer.items()})
    npz = str(tmp / "gpt.npz")
    np.savez(npz, **flat)
    files = {}
    for pkg, imports, dtype in (
            ("jax", "import jax.numpy as jnp\nfrom nnstreamer_tpu.models."
             "transformer import GPTConfig", "jnp.float32"),
            ("port", "import torch\nfrom nnstreamer_tpu_torch.models."
             "transformer import GPTConfig", "torch.float32")):
        path = tmp / f"lm_{pkg}.py"
        path.write_text(LM_PY.format(imports=imports, npz=npz, dtype=dtype))
        files[pkg] = str(path)
    return {"jax": lambda c: mk_jax(c, files["jax"]),
            "port": lambda c: mk(c, files["port"])}


# -- (a) the KV wire ---------------------------------------------------------------

def _kv_arrays():
    """A stream's K/V as bf16 bit patterns and its f32 logits, seeded."""
    rng = np.random.default_rng(1)
    bits = [pt_wire.f32_to_bf16_bits(
        rng.standard_normal((2, 6, 2, 8)).astype(np.float32))
        for _ in range(2)]
    return bits, rng.standard_normal(32).astype(np.float32)


def _as_pkg(bits, pkg):
    """bf16 bits as the package's host bf16: an ml_dtypes array for JAX,
    a CPU bf16 tensor for the port."""
    if pkg == "jax":
        return bits.view(ml_dtypes.bfloat16)
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def _bits_of(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


KV_MODS = {"jax": nt_kv, "port": pt_kv}
LINKS = [("port", "port"), ("jax", "port"), ("port", "jax")]


def _roundtrip(tx_pkg, rx_pkg, precision):
    (kb, vb), logits = _kv_arrays()
    got = {}
    evt = threading.Event()

    def on_kv(d):
        got.update(d)
        evt.set()
        return True

    rx = KV_MODS[rx_pkg].KvReceiver("127.0.0.1", 0, on_kv,
                                    precision=precision).start()
    tx = KV_MODS[tx_pkg].KvSender("127.0.0.1", rx.bound_port,
                                  precision=precision)
    try:
        ack = tx.send("sid1", [1, 2, 3], _as_pkg(kb, tx_pkg),
                      _as_pkg(vb, tx_pkg), logits, remaining=7, seed=5,
                      emitted=[9])
        assert ack["adopted"] is True and ack["sid"] == "sid1"
        assert evt.wait(10)
    finally:
        tx.close()
        rx.stop()
    return kb, vb, logits, got


@pytest.mark.parametrize("tx_pkg,rx_pkg", LINKS)
def test_raw_precision_is_byte_exact(tx_pkg, rx_pkg):
    kb, vb, logits, got = _roundtrip(tx_pkg, rx_pkg, "none")
    np.testing.assert_array_equal(_bits_of(got["k"]), kb)
    np.testing.assert_array_equal(_bits_of(got["v"]), vb)
    np.testing.assert_array_equal(np.asarray(got["logits"]), logits)
    assert got["prompt"].tolist() == [1, 2, 3]
    assert got["remaining"] == 7 and got["seed"] == 5
    assert got["emitted"] == [9]


@pytest.mark.parametrize("tx_pkg,rx_pkg", LINKS)
def test_bf16_precision_keeps_native_kv_exact(tx_pkg, rx_pkg):
    """bf16 K/V never pass through the downcast (only f32 payloads do):
    byte-exact; the f32 logits are rounded to bf16 and come back within
    rtol 8e-3 (bf16 keeps 8 significant bits: 2**-8 = 3.9e-3 of a
    value's magnitude)."""
    kb, vb, logits, got = _roundtrip(tx_pkg, rx_pkg, "bf16")
    np.testing.assert_array_equal(_bits_of(got["k"]), kb)
    np.testing.assert_array_equal(_bits_of(got["v"]), vb)
    gl = np.asarray(got["logits"])
    assert gl.dtype == np.float32
    assert not np.array_equal(gl, logits)   # provably downcast
    np.testing.assert_allclose(gl, logits, rtol=8e-3)


@pytest.mark.parametrize("tx_pkg,rx_pkg", LINKS)
def test_refused_adoption_acks_false(tx_pkg, rx_pkg):
    rx = KV_MODS[rx_pkg].KvReceiver("127.0.0.1", 0, lambda d: False).start()
    tx = KV_MODS[tx_pkg].KvSender("127.0.0.1", rx.bound_port)
    try:
        ack = tx.send("s", [1], np.zeros((1, 1, 1, 1), np.float32),
                      np.zeros((1, 1, 1, 1), np.float32),
                      np.zeros(4, np.float32), remaining=1, seed=0)
        assert ack["adopted"] is False
    finally:
        tx.close()
        rx.stop()


@pytest.mark.parametrize("precision", ["none", "bf16", "fp16"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32"])
def test_pack_kv_bytes_equal_across_packages(precision, kv_dtype):
    """The same stream packs to the same KV_XFER meta and payload bytes
    in both packages, on a link of each precision."""
    (kb, vb), logits = _kv_arrays()

    def kv_of(pkg):
        if kv_dtype == "float32":
            return (pt_wire.bf16_bits_to_f32(kb), pt_wire.bf16_bits_to_f32(vb))
        return _as_pkg(kb, pkg), _as_pkg(vb, pkg)

    packed = {}
    for pkg, w, mod in (("jax", nt_wire, nt_kv), ("port", pt_wire, pt_kv)):
        cfg = w.negotiate(w.advertise("raw", precision), "raw", precision)
        k, v = kv_of(pkg)
        meta, payloads = mod.pack_kv("sid", [4, 5, 6], k, v, logits,
                                     remaining=3, seed=9, emitted=[1, 2],
                                     cfg=cfg)
        packed[pkg] = (meta, [bytes(memoryview(p).cast("B"))
                              if not isinstance(p, bytes) else p
                              for p in payloads])
    assert packed["port"][0] == packed["jax"][0]
    assert packed["port"][1] == packed["jax"][1]


# -- (b) the split ------------------------------------------------------------------

def test_split_equals_monolithic():
    prompt = [1, 2, 3, 4, 5, 6, 7]
    mono = gen(mk, "max_tokens:8,n_parallel:2,max_len:64,seed:3", [prompt], 8)
    out, pre, dec = split(mk, mk, "max_tokens:8,max_len:64,seed:3",
                          [prompt], 8)
    # the stream id is the prompt's content digest
    assert out == {_sha(prompt): mono[0]}
    assert pre["kv_handoffs_out"] == 1 and pre["kv_handoff_errors"] == 0
    assert dec["kv_handoffs_in"] == 1
    assert dec["kv_shipped_tokens"] == len(prompt)
    # the decode replica computed no prompt token itself
    assert dec["prefill_computed_tokens"] == 0
    assert dec["prefill_dispatches"] == 0


def test_sampled_split_equals_monolithic():
    """The decode replica seats a shipped stream with the prefill
    replica's seed: a sampled split emits the monolithic stream."""
    prompt = [9, 8, 7, 6]
    custom = "max_tokens:10,max_len:64,seed:17,temperature:0.9,top_k:16"
    mono = gen(mk, custom + ",n_parallel:2", [prompt], 10)
    out, _, dec = split(mk, mk, custom, [prompt], 10)
    assert out == {_sha(prompt): mono[0]}
    assert dec["kv_handoffs_in"] == 1


# the split's counters that do not depend on when each handoff arrives
# (the decode steps do: a stream admitted a round later shares fewer)
SPLIT_KEYS = ("kv_shipped_tokens", "kv_handoffs_in", "kv_handoffs_out",
              "kv_handoff_errors", "prefill_dispatches",
              "prefill_computed_tokens", "prefill_cached_tokens")
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16, 17, 18]]


def test_split_equals_the_jax_split_f32(lm):
    """Three prompts through each package's split on one float32 weight
    set: the same greedy tokens a stream and the same counters on both
    replicas."""
    custom = "max_tokens:8,max_len:64,seed:3,block_size:8"
    got = split(lm["port"], lm["port"], custom, PROMPTS, 8)
    want = split(lm["jax"], lm["jax"], custom, PROMPTS, 8)
    assert got[0] == want[0]
    assert set(got[0]) == {_sha(p) for p in PROMPTS}
    for side in (1, 2):
        assert {k: got[side][k] for k in SPLIT_KEYS} == \
            {k: want[side].get(k, 0) for k in SPLIT_KEYS}


@pytest.mark.parametrize("pre_pkg,dec_pkg", [("jax", "port"),
                                             ("port", "jax")],
                         ids=["jax-prefill-port-decode",
                              "port-prefill-jax-decode"])
def test_cross_package_split_equals_monolithic(lm, pre_pkg, dec_pkg):
    """One package's prefill replica ships to the other's decode replica
    over KV_XFER: the streams are the port's monolithic tokens."""
    custom = "max_tokens:8,max_len:64,seed:3"
    mono = gen(lm["port"], custom + ",n_parallel:2", PROMPTS, 8)
    out, pre, dec = split(lm[pre_pkg], lm[dec_pkg], custom, PROMPTS, 8)
    assert out == {_sha(p): mono[i] for i, p in enumerate(PROMPTS)}
    assert pre["kv_handoffs_out"] == 3 and pre["kv_handoff_errors"] == 0
    assert dec["kv_handoffs_in"] == 3
    assert dec["kv_shipped_tokens"] == sum(len(p) for p in PROMPTS)
    assert dec["prefill_computed_tokens"] == 0


def test_role_both_and_kv_precision_are_accepted():
    """role:both is the monolithic filter; kv_precision alone changes
    nothing without a link."""
    prompt = [3, 1, 4, 1, 5]
    a = gen(mk, "max_tokens:6,n_parallel:2,max_len:32", [prompt], 6)
    b = gen(mk, "max_tokens:6,n_parallel:2,max_len:32,role:both,"
                "kv_precision:bf16", [prompt], 6)
    assert a == b


def test_unknown_role_and_missing_handoff_are_refused():
    with pytest.raises(ValueError, match="role"):
        mk("role:router")
    f = mk("max_tokens:4,max_len:32,role:prefill")
    try:
        f.invoke_async([np.array([1, 2], np.int32)])
        deadline = time.monotonic() + WAIT_S
        while f.stats["kv_handoff_errors"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        # no handoff target: counted and logged, nothing dispatched
        assert f.stats["kv_handoff_errors"] == 1
        assert f.stats["kv_handoffs_out"] == 0
    finally:
        f.close()


def test_handoff_port_property_resolves_the_bound_port():
    f = mk("max_tokens:4,n_parallel:2,max_len:32,handoff_port:0")
    try:
        assert f.handoff_port and f.handoff_port > 0
    finally:
        f.close()
    assert f.handoff_port is None
    g = mk("max_tokens:4,n_parallel:2,max_len:32")
    assert g.handoff_port is None
    g.close()


# -- (c) the trace tree ---------------------------------------------------------------

def test_trace_tree_is_connected():
    from nnstreamer_tpu_torch.obs import spans
    assert spans.enabled()
    spans.clear()
    split(mk, mk, "max_tokens:8,max_len:64,seed:3", [[2, 4, 6, 8]], 8)
    mine = {}
    for _tid, (name, _cat, _ts, _dur, trace, sid, parent) in \
            spans.snapshot():
        if name in ("llm-prefill", "kv-handoff", "llm-decode"):
            mine[name] = (trace, sid, parent)
    assert set(mine) == {"llm-prefill", "kv-handoff", "llm-decode"}
    # one trace id, and the parent chain links the three hops
    assert len({t for t, _, _ in mine.values()}) == 1
    assert mine["kv-handoff"][2] == mine["llm-prefill"][1]
    assert mine["llm-decode"][2] == mine["kv-handoff"][1]


def test_span_rings_record_and_clear():
    """The rings keep each thread's spans, parented on the context."""
    from nnstreamer_tpu_torch.obs import context, spans
    spans.clear()
    ctx = context.TraceContext(context.next_id(), 0, time.time_ns())
    root = spans.record_root("src", ctx)
    child = spans.record_span("hop", "wire", time.time_ns(), 5, ctx)
    recs = [s for _tid, s in spans.snapshot()]
    assert ("src", "source", ctx.t0_ns, 0, ctx.trace_id, root, 0) in recs
    assert any(s[0] == "hop" and s[5] == child and s[6] == root
               for s in recs)
    assert threading.current_thread().name in spans.thread_names().values()
    spans.clear()
    assert spans.snapshot() == []


# -- (d) admission on the decode side ----------------------------------------------

def test_handoff_seat_points_past_the_budget_at_the_discard_block():
    """A shipped stream's table columns past its blocks aim at the
    discard block, as an admitted one's do (the JAX seat aims them at
    block 0, nnstreamer_tpu/filters/llm.py:311-318)."""
    from nnstreamer_tpu_torch.filters.llm import _PagedBackend
    f = mk("max_tokens:3,n_parallel:2,max_len:32,paged:true,block_size:8,"
           "pool_blocks:8")
    try:
        be = _PagedBackend(f, 2, 32)
        prompt = np.arange(1, 6, dtype=np.int32)
        kv = {"prompt": prompt,
              "k": torch.zeros(2, 5, 4, 8, dtype=torch.bfloat16),
              "v": torch.zeros(2, 5, 4, 8, dtype=torch.bfloat16),
              "logits": np.zeros(64, np.float32)}
        be.seat(0, 5, be.admit_handoff(0, prompt, kv, 3), 0)
        assert len(be.blocks[0]) == 1
        assert be.table_np[0].tolist() == [be.blocks[0][0]] + [8] * 3
        assert f.stats["kv_shipped_tokens"] == 5
        be.free(0)
    finally:
        f.close()


def test_handoff_larger_than_the_pool_acks_false(lm):
    """A stream that needs more blocks than pool_blocks holds: the port's
    decode replica refuses it in the ack, so the prefill side counts the
    error; the JAX replica acks it adopted and its scheduler drops it
    (nnstreamer_tpu/filters/llm.py:801-825 against :989-1001)."""
    custom = "max_tokens:24,max_len:64,block_size:8,pool_blocks:2"
    prompt = np.arange(1, 10, dtype=np.int32)   # 9 + 24 tokens: 5 blocks
    for pkg, errors in (("port", 1), ("jax", 0)):
        dec = lm[pkg](custom + ",n_parallel:2,role:decode,handoff_port:0")
        pre = lm["port"](custom + f",role:prefill,handoff:127.0.0.1:"
                         f"{dec.handoff_port}")
        try:
            pre.invoke_async([prompt])
            deadline = time.monotonic() + WAIT_S
            while pre.stats["kv_handoffs_out"] < 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert pre.stats["kv_handoffs_out"] == 1
            assert pre.stats["kv_handoff_errors"] == errors, pkg
            assert dec.stats["kv_handoffs_in"] == 1 - errors, pkg
        finally:
            pre.close()
            dec.close()


def test_unpaged_replica_refuses_a_handoff_in_its_ack():
    """A filter listening on handoff_port without the paged pool cannot
    fold shipped K/V: it says so in the ack (the JAX filter acks it and
    drops the stream at admission)."""
    dec = mk("max_tokens:4,n_parallel:2,max_len:32,handoff_port:0")
    pre = mk(f"max_tokens:4,max_len:32,role:prefill,"
             f"handoff:127.0.0.1:{dec.handoff_port}")
    try:
        pre.invoke_async([np.array([1, 2, 3], np.int32)])
        deadline = time.monotonic() + WAIT_S
        while pre.stats["kv_handoffs_out"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert pre.stats["kv_handoff_errors"] == 1
        assert dec.stats["kv_handoffs_in"] == 0
    finally:
        pre.close()
        dec.close()


# -- (e) the stream snapshot ------------------------------------------------------

def _snapshot_and_adopt(filt_cls, adopt):
    f = filt_cls()
    with f._cond:
        f._streams = [
            {"prompt": np.array([5, 6], np.int32),
             "emitted": [7, 8], "remaining": 4, "pos": 4},
            None,
        ]
        f._pending = [(np.array([1, 2, 3], np.int32), None, None)]
    state = f.snapshot_state(None)
    g = filt_cls()
    g.restore_state(copy.deepcopy(state), None)
    got = []
    with g._cond:
        for p in ([9, 9], [5, 6], [1, 2, 3]):
            got.append(adopt(g, np.array(p, np.int32)))
        got.append(g._recovered)
    return state, got


def test_llm_stream_snapshot_and_adoption():
    """tests/test_checkpoint.py:334 on both packages: the same state
    dict, and the same adoptions from it (the port's also returns the
    draws a re-adopted stream already took)."""
    from nnstreamer_tpu.filters.llm import LlmFilter as JaxLlm
    from nnstreamer_tpu_torch.filters.llm import LlmFilter

    def jax_adopt(g, p):
        rem, flat = g._adopt_recovered_locked(p)
        return rem, flat.tolist()

    def port_adopt(g, p):
        rem, flat, drawn = g._adopt_recovered_locked(p)
        assert drawn == len(flat) - len(p)
        return rem, flat.tolist()

    state, got = _snapshot_and_adopt(LlmFilter, port_adopt)
    want_state, want = _snapshot_and_adopt(JaxLlm, jax_adopt)
    assert state == want_state == {"streams": [
        {"prompt": [5, 6], "emitted": [7, 8], "remaining": 4},
        {"prompt": [1, 2, 3], "emitted": [], "remaining": None},
    ]}
    assert got == want == [(None, [9, 9]), (4, [5, 6, 7, 8]),
                           (None, [1, 2, 3]), None]


def test_idle_filter_snapshots_nothing():
    f = mk("max_tokens:4,n_parallel:2,max_len:32")
    try:
        assert f.snapshot_state(None) is None
    finally:
        f.close()


# -- (f) the decode-kill resume ------------------------------------------------------

def _decode_kill(make, custom, prompt, n_tok):
    """TestChaosDecodeKill's flow: ship, close both replicas once half the
    tokens arrived, snapshot the decode replica; a fresh decode replica
    restores it and a fresh prefill replica re-ships the prompt.
    -> (delivered, rest, snapshot, resumed decode replica's stats)."""
    d1 = make(custom + ",n_parallel:2,role:decode,handoff_port:0")
    got = []
    half = threading.Event()
    lock = threading.Lock()

    def disp1(outs, ctx):
        with lock:
            got.append(int(np.asarray(outs[0]).ravel()[0]))
            if len(got) >= n_tok // 2:
                half.set()

    d1.set_async_dispatcher(disp1)
    p1 = make(custom + f",role:prefill,handoff:127.0.0.1:{d1.handoff_port}")
    p1.invoke_async([np.asarray(prompt, np.int32)], ctx=None)
    assert half.wait(WAIT_S)
    # close() joins the scheduler at a round's end: the snapshot's
    # emitted list is exactly what the dispatcher delivered
    p1.close()
    d1.close()
    with lock:
        delivered = list(got)
    snap = d1.snapshot_state(None)
    d2 = make(custom + ",n_parallel:2,role:decode,handoff_port:0")
    d2.restore_state(copy.deepcopy(snap), None)
    rest = []
    done = threading.Event()

    def disp2(outs, ctx):
        rest.append(int(np.asarray(outs[0]).ravel()[0]))
        if len(rest) >= n_tok - len(delivered):
            done.set()

    d2.set_async_dispatcher(disp2)
    p2 = make(custom + f",role:prefill,handoff:127.0.0.1:{d2.handoff_port}")
    try:
        p2.invoke_async([np.asarray(prompt, np.int32)], ctx=None)
        assert done.wait(WAIT_S)
    finally:
        p2.close()
        d2.close()
    return delivered, rest, snap, dict(d2.stats.snapshot())


def test_decode_kill_exact_token_resume_equals_jax(lm):
    """The port's resume gives its monolithic stream, zero tokens lost or
    repeated, and the JAX package's concatenation, at float32."""
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    n_tok = 24
    custom = f"max_tokens:{n_tok},max_len:64,seed:3"
    mono = gen(lm["port"], custom + ",n_parallel:2", [prompt], n_tok)[0]
    delivered, rest, snap, st = _decode_kill(lm["port"], custom, prompt,
                                             n_tok)
    ent, = snap["streams"]
    assert ent["emitted"] == delivered
    assert ent["remaining"] == n_tok - len(delivered)
    assert delivered + rest == mono
    # only the emitted suffix was recomputed over the shipped prompt K/V
    assert st["kv_shipped_tokens"] == len(prompt)
    assert st["prefill_computed_tokens"] == len(delivered)
    jd, jr, _, _ = _decode_kill(lm["jax"], custom, prompt, n_tok)
    assert jd + jr == delivered + rest


def test_sampled_resume_continues_the_straight_run(lm):
    """A re-adopted stream's sampling counter starts at the draws it
    already took, so a sampled resume emits the straight run's tokens
    (the port's choice: JAX resumes with a fresh key)."""
    prompt = [4, 3, 2, 1, 4, 3]
    n_tok = 16
    custom = (f"max_tokens:{n_tok},max_len:64,seed:21,temperature:0.8,"
              "top_k:24")
    straight = gen(lm["port"], custom + ",n_parallel:2", [prompt],
                   n_tok)[0]
    delivered, rest, _, _ = _decode_kill(lm["port"], custom, prompt, n_tok)
    assert 0 < len(delivered) < n_tok
    assert delivered + rest == straight


def test_resubmitted_prompt_adopts_its_snapshot():
    """The other re-adoption caller: a re-submitted prompt (no handoff)
    continues a restored stream with the remaining budget."""
    prompt = [6, 5, 4, 3, 2]
    custom = "max_tokens:10,n_parallel:2,max_len:32,seed:4"
    straight = gen(mk, custom, [prompt], 10)[0]
    g = mk(custom)
    try:
        g.restore_state({"streams": [{"prompt": prompt,
                                      "emitted": straight[:4],
                                      "remaining": 6}]}, None)
        rest = collect(g, [prompt], 6)[0]
        assert g._recovered is None
        assert g.stats["prefill_computed_tokens"] == len(prompt) + 4
    finally:
        g.close()
    assert straight[:4] + rest == straight


# -- (g) a pipeline's snapshot -----------------------------------------------------

LLM_LINE = ('appsrc name=in caps="other/tensors,format=flexible" '
            "! tensor_filter name=f framework=llm accelerator=true:cpu "
            f'model="{ZOO}" custom="max_tokens:24,n_parallel:2,max_len:48,'
            'seed:2" invoke-async=true ! appsink name=out')


def _tokens(pipe):
    return [int(np.asarray(b.chunks[0].host()).ravel()[0])
            for b in pipe["out"].buffers]


def _wait_tokens(pipe, n):
    deadline = time.monotonic() + WAIT_S
    while len(pipe["out"].buffers) < n and time.monotonic() < deadline:
        time.sleep(0.005)
    return _tokens(pipe)


def test_pipeline_snapshot_restore_continues_the_stream(tmp_path):
    """Pipeline.preempt snapshots an llm line mid-stream; a fresh line
    restored from it continues the stream when the prompt comes again:
    the snapshot's emitted tokens plus the new line's are the straight
    run's."""
    prompt = np.array([1, 2, 3, 4, 5, 6], np.int32)
    pipe = pt.parse_launch(LLM_LINE)
    pipe.start()
    pipe["in"].push_buffer(pt.Buffer.from_arrays([prompt]))
    straight = _wait_tokens(pipe, 24)
    pipe["in"].end_stream()
    pipe.stop()
    assert len(straight) == 24

    ckpt = str(tmp_path / "ckpt")
    pipe = pt.parse_launch(LLM_LINE)
    pipe.start()
    pipe["in"].push_buffer(pt.Buffer.from_arrays([prompt]))
    _wait_tokens(pipe, 4)
    report = pipe.preempt(0.05, ckpt)
    assert report["snapshot"]

    pipe2 = pt.parse_launch(LLM_LINE)
    pipe2.restore(ckpt)
    state = pipe2["f"]._fw_restore[0]
    ent, = state["streams"]
    assert ent["prompt"] == prompt.tolist()
    emitted = ent["emitted"]
    assert 4 <= len(emitted) < 24
    assert ent["remaining"] == 24 - len(emitted)
    pipe2.start()
    try:
        pipe2["in"].push_buffer(pt.Buffer.from_arrays([prompt]))
        rest = _wait_tokens(pipe2, ent["remaining"])
    finally:
        pipe2["in"].end_stream()
        pipe2.stop()
    assert emitted + rest == straight


# -- (h) llm-role on REGISTER and PONG -----------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _fleet_models():
    from nnstreamer_tpu.filters import register_custom_easy as nt_register
    from nnstreamer_tpu_torch.filters import register_custom_easy
    register_custom_easy("disagg_double", lambda x: x * 2)
    nt_register("disagg_double", lambda x: x * 2)
    yield


def _replica(pkg, role, extra=""):
    return pkg.parse_launch(
        f"tensor_serve_src name=src port=0 id=5 buckets=1,2 max-wait-ms=2 "
        f"llm-role={role} {extra}"
        "! tensor_filter framework=custom-easy model=disagg_double "
        "! tensor_serve_sink id=5")


def _wait_for(pred, timeout=15):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return bool(pred())


@pytest.mark.parametrize("pkg", [nt, pt], ids=["jax-replicas",
                                               "port-replicas"])
def test_router_reads_llm_roles_from_pongs(pkg):
    """The port's router reads each replica's phase from its PONG load
    reports and steers a prompt to the prefill replica and a stream's
    decode home to the decode one."""
    reps = [_replica(pkg, role) for role in ("prefill", "decode")]
    for r in reps:
        r.start()
    ports = [r["src"].bound_port for r in reps]
    rp = pt.parse_launch(
        f"tensor_serve_router name=rt port=0 "
        f"replicas=localhost:{ports[0]},localhost:{ports[1]} "
        "heartbeat-ms=50")
    rp.start()
    rt = rp["rt"]
    try:
        def roles():
            return {k: v["llm_role"] for k, v in rt.router_report().items()}
        assert _wait_for(lambda: set(roles().values()) ==
                         {"prefill", "decode"}), roles()
        assert roles() == {f"localhost:{ports[0]}": "prefill",
                           f"localhost:{ports[1]}": "decode"}
        router = rt.router
        got = router._pick("s1", set(), "prompt")
        assert got is not None and got[0] == f"localhost:{ports[0]}"
        assert router.decode_home("s1") == f"localhost:{ports[1]}"
    finally:
        rp.stop()
        for r in reps:
            r.stop()


@pytest.mark.parametrize("pkg", [nt, pt], ids=["jax-replica",
                                               "port-replica"])
def test_register_carries_the_llm_role(pkg):
    from nnstreamer_tpu_torch.edge.broker import DiscoveryBroker, \
        discover_meta
    broker = DiscoveryBroker(port=0)
    broker.start()
    try:
        sp = _replica(pkg, "decode", "connect-type=HYBRID topic=llm-d "
                      f"dest-port={broker.bound_port} ")
        sp.start()
        try:
            assert _wait_for(lambda: broker.entries("llm-d"))
            (_, port), meta = discover_meta("localhost", broker.bound_port,
                                            "llm-d")[0]
            assert port == sp["src"].bound_port
            assert meta["llm_role"] == "decode" and meta["role"] == "serve"
        finally:
            sp.stop()
    finally:
        broker.stop()


# -- (i) pipelint's llm-prefix-cache-lossy-link --------------------------------------

LOSSY = [
    ("tensor_serve_src name=s llm-role=prefill ! "  # pipelint: skip
     "tensor_filter name=f framework=llm model=zoo://gpt "
     'custom="role:prefill,handoff:127.0.0.1:6000,kv_precision:fp16" '
     "! tensor_serve_sink", [("f", "WARNING")]),
    ("tensor_serve_src name=s llm-role=prefill ! "
     "tensor_filter name=f framework=llm model=zoo://gpt "
     'custom="role:prefill,handoff:127.0.0.1:6000,kv_precision:bf16" '
     "! tensor_serve_sink", []),
    ("tensor_serve_src name=s llm-role=decode ! "
     "tensor_filter name=f framework=llm model=zoo://gpt "
     'custom="role:decode,pool_blocks:64,kv_precision:fp16,'
     'prefix_cache:false" ! tensor_serve_sink', []),
]


@pytest.mark.parametrize("desc,want", LOSSY,
                         ids=["fp16-into-prefix-cache-warns",
                              "bf16-is-clean", "fp16-without-cache-clean"])
def test_prefix_cache_lossy_link_matches_the_jax_rule(desc, want):
    from nnstreamer_tpu.analysis import analyze as nt_analyze
    from nnstreamer_tpu_torch.analysis import analyze

    def found(report):
        return sorted((f.element, f.severity.name, f.message)
                      for f in report.findings
                      if f.rule == "llm-prefix-cache-lossy-link")

    got = found(analyze(pt.parse_launch(desc)))
    assert got == found(nt_analyze(nt.parse_launch(desc)))
    assert [(e, s) for e, s, _ in got] == want
    if want:
        assert "fp16" in got[0][2] and "bf16" in got[0][2]
