"""The generative line of the port against the JAX package's, on the CPU.

The transformer functions (``models/transformer.py``) run the same
weights as the JAX ones — the JAX ``init_params`` tree carried across by
``gpt_params_from_jax`` — at float32, with logits within 1e-5 of the
largest (summation order only), and at bfloat16, teacher-forced on the
JAX package's tokens (the two round bf16 intermediates at other points).
The filter (``filters/llm.py``) emits the JAX filter's greedy tokens at
float32 through a ``get_lm()`` file each. Then the port's own mirrors of
tests/test_llm.py and of tests/test_llm_disagg.py's paged-pool classes:
paged equals contiguous, chunked equals per-token, the prefix cache hits
with exact tokens. The config's mesh fields are the JAX config's (their
sharded runs are tests/test_torch_parallel.py's); the KV link
and the stream snapshot have their own file,
tests/test_torch_llm_disagg.py. Sampled tokens are the port's own
(per-stream hash noise, not ``jax.random``); the candidate sets are
JAX's.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.filters.base import FilterProperties as JaxProps
from nnstreamer_tpu.filters.registry import find_filter as jax_find
from nnstreamer_tpu.models import transformer as J
from nnstreamer_tpu_torch.filters import find_filter
from nnstreamer_tpu_torch.filters.base import Accelerator, FilterProperties
from nnstreamer_tpu_torch.models import transformer as T
from nnstreamer_tpu_torch.models.convert import gpt_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = "zoo://gpt?vocab=64&d_model=32&n_heads=4&n_layers=2"
CPU = "accelerator=true:cpu"
CAPS = ('other/tensors,format=static,num_tensors=1,'
        'types=(string)int32,dimensions=(string)4')
F32_TOL = 1e-5      # of the largest |logit|: summation order only


# -- weights shared by both packages -------------------------------------------

def _pair(dtype="float32", seed=1, **kw):
    """(JAX cfg, JAX params, port cfg, port GPT) on the same weights."""
    dims = dict(vocab=64, d_model=32, n_heads=4, n_layers=2)
    dims.update(kw)
    jcfg = J.GPTConfig(dtype=getattr(jnp, dtype), **dims)
    jparams = J.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    tcfg = T.GPTConfig(dtype=getattr(torch, dtype), **dims)
    model = T.GPT(tcfg)
    model.load_state_dict(gpt_params_from_jax(tree))
    return jcfg, jparams, tcfg, model


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, tol=F32_TOL):
    want, got = _np(want), _np(got)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


# -- transformer functions at float32 ------------------------------------------

def test_forward_matches_jax_f32():
    jcfg, jp, tcfg, m = _pair()
    toks = np.array([[3, 11, 25, 40, 7, 19], [1, 2, 3, 4, 5, 6]], np.int32)
    _close(T.forward(m, _t(toks), tcfg), J.forward(jp, jnp.asarray(toks),
                                                   jcfg))


@pytest.mark.parametrize("true_len", [6, 3, 0])
def test_prefill_true_len_matches_jax_f32(true_len):
    """Bucket-padded prefill: logits from position true_len-1, K/V
    written at every padded position, the index set to true_len. A
    zero-length prompt reads row 0, as the JAX code's comment says
    ``dynamic_slice_in_dim`` clamps; JAX 0.9's wraps a negative start
    instead (``allow_negative_indices=True``) and reads the padded tail,
    so for 0 the JAX logits are taken at true_len 1 (the row the clamp
    reads). The filter refuses an empty prompt before either."""
    jcfg, jp, tcfg, m = _pair()
    toks = np.array([[3, 11, 25, 40, 7, 19, 0, 0]], np.int32)
    jl, jc = J.prefill(jp, J.init_cache(jcfg, 1, 16), jnp.asarray(toks),
                       jcfg, true_len=jnp.asarray(max(true_len, 1),
                                                  jnp.int32))
    tl, tc = T.prefill(m, T.init_cache(tcfg, 1, 16), _t(toks), tcfg,
                       true_len=true_len)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert int(tc["index"]) == true_len


def _multi_caches(jcfg, jp, tcfg, m, lens, max_len):
    jm = J.init_cache_multi(jcfg, len(lens), max_len)
    tm = T.init_cache_multi(tcfg, len(lens), max_len)
    for slot, n in enumerate(lens):
        p = (np.arange(n, dtype=np.int32) * 5 + slot) % jcfg.vocab
        _, c1 = J.prefill(jp, J.init_cache(jcfg, 1, max_len),
                          jnp.asarray(p[None]), jcfg)
        jm = J.cache_insert(jm, c1, jnp.asarray(slot, jnp.int32))
        _, t1 = T.prefill(m, T.init_cache(tcfg, 1, max_len), _t(p[None]),
                          tcfg)
        T.cache_insert(tm, t1, slot)
    return jm, tm


def test_decode_step_multi_inactive_and_at_capacity_matches_jax_f32():
    """Three lanes: active, at max_len (guarded: no write, no advance),
    inactive. Logits, positions and the whole cache agree with JAX over
    four steps."""
    jcfg, jp, tcfg, m = _pair()
    jm, tm = _multi_caches(jcfg, jp, tcfg, m, [3, 8, 5], 8)
    active = np.array([True, True, False])
    for step in range(4):
        tok = np.array([5 + step, 6, 7], np.int32)
        jl, jm = J.decode_step_multi(jp, jm, jnp.asarray(tok),
                                     jnp.asarray(active), jcfg)
        tl, tm = T.decode_step_multi(m, tm, _t(tok), torch.from_numpy(active),
                                     tcfg)
        _close(tl, jl)
        np.testing.assert_array_equal(tm["index"].numpy(),
                                      np.asarray(jm["index"]))
        _close(tm["k"], jm["k"])
        _close(tm["v"], jm["v"])
    assert tm["index"].tolist() == [7, 8, 5]


def _pools(jcfg, jp, tcfg, m, prompts, bs, nb, max_len):
    """Both pools with each prompt's prefill K/V in its own blocks."""
    jpool = J.init_kv_pool(jcfg, nb, bs)
    tpool = T.init_kv_pool(tcfg, nb, bs)
    w = -(-max_len // bs)
    table = np.zeros((len(prompts), w), np.int32)
    logits = []
    for slot, p in enumerate(prompts):
        l1, c1 = J.prefill(jp, J.init_cache(jcfg, 1, max_len),
                           jnp.asarray(p[None]), jcfg)
        blocks = np.arange(slot * w, (slot + 1) * w, dtype=np.int32)
        sh = (jcfg.n_layers, w, bs, jcfg.n_heads, jcfg.head_dim)
        k = np.array(c1["k"][:, 0]).reshape(sh)
        v = np.array(c1["v"][:, 0]).reshape(sh)
        jpool = J.pool_insert(jpool, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(blocks))
        T.pool_insert(tpool, torch.from_numpy(k), torch.from_numpy(v),
                      _t(blocks))
        table[slot] = blocks
        logits.append(np.asarray(l1[0]))
    return jpool, tpool, table, np.stack(logits)


def test_decode_step_paged_matches_jax_f32():
    """The paged step on both pools: logits, positions and the arena
    (the port's discard block NB aside) agree; an inactive lane writes
    nothing into the allocator's blocks."""
    jcfg, jp, tcfg, m = _pair()
    bs, max_len = 4, 16
    prompts = [np.array([1, 2, 3, 4, 5], np.int32),
               np.array([7, 8, 9], np.int32)]
    jpool, tpool, table, _ = _pools(jcfg, jp, tcfg, m, prompts, bs, 8,
                                    max_len)
    jidx = jnp.asarray([5, 3], jnp.int32)
    tidx = torch.tensor([5, 3])
    for step in range(5):
        active = np.array([True, step < 2])
        tok = np.array([step + 1, step + 2], np.int32)
        jl, jpool, jidx = J.decode_step_paged(
            jp, jpool, jnp.asarray(table), jidx, jnp.asarray(tok),
            jnp.asarray(active), jcfg, max_len=max_len)
        tl, tpool, tidx = T.decode_step_paged(
            m, tpool, _t(table), tidx, _t(tok), torch.from_numpy(active),
            tcfg, max_len=max_len)
        _close(tl, jl)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        _close(tpool["k"][:, :8], jpool["k"])
        _close(tpool["v"][:, :8], jpool["v"])


@pytest.mark.parametrize("past_len,true_len", [(8, 4), (5, 7), (0, 3)])
def test_prefill_with_past_matches_jax_f32(past_len, true_len):
    jcfg, jp, tcfg, m = _pair()
    toks = np.arange(1, 21, dtype=np.int32)
    _, c = J.prefill(jp, J.init_cache(jcfg, 1, 16),
                     jnp.asarray(toks[None, :16]), jcfg)
    past_k, past_v = c["k"][:, 0], c["v"][:, 0]     # 16 rows, some valid
    suffix = np.zeros(8, np.int32)
    suffix[:true_len] = toks[past_len:past_len + true_len]
    jl, jk, jv = J.prefill_with_past(
        jp, past_k, past_v, jnp.asarray(past_len, jnp.int32),
        jnp.asarray(suffix[None]), jcfg,
        true_len=jnp.asarray(true_len, jnp.int32))
    tl, tk, tv = T.prefill_with_past(
        m, torch.from_numpy(np.array(past_k)),
        torch.from_numpy(np.array(past_v)), past_len, _t(suffix[None]),
        tcfg, true_len=true_len)
    _close(tl, jl)
    _close(tk[:, :true_len], np.asarray(jk)[:, :true_len])
    _close(tv[:, :true_len], np.asarray(jv)[:, :true_len])


def test_pool_ops_match_jax():
    """pool_insert, pool_copy_block and pool_gather move the same
    values; the port's arena has the discard block past the end."""
    jcfg, _, tcfg, _ = _pair()
    bs, nb = 4, 8
    rng = np.random.default_rng(0)
    sh = (jcfg.n_layers, 2, bs, jcfg.n_heads, jcfg.head_dim)
    kb = rng.standard_normal(sh).astype(np.float32)
    vb = rng.standard_normal(sh).astype(np.float32)
    jpool = J.pool_insert(J.init_kv_pool(jcfg, nb, bs), jnp.asarray(kb),
                          jnp.asarray(vb), jnp.asarray([5, 2], jnp.int32))
    tpool = T.pool_insert(T.init_kv_pool(tcfg, nb, bs), torch.from_numpy(kb),
                          torch.from_numpy(vb), torch.tensor([5, 2]))
    assert tuple(tpool["k"].shape) == (jcfg.n_layers, nb + 1) + sh[2:]
    jpool = J.pool_copy_block(jpool, 5, 7)
    T.pool_copy_block(tpool, 5, 7)
    np.testing.assert_array_equal(tpool["k"][:, :nb].numpy(),
                                  np.asarray(jpool["k"]))
    jk, jv = J.pool_gather(jpool, jnp.asarray([7, 2], jnp.int32))
    tk, tv = T.pool_gather(tpool, torch.tensor([7, 2]))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_decode_chunk_greedy_matches_jax_f32():
    jcfg, jp, tcfg, m = _pair()
    jm, tm = _multi_caches(jcfg, jp, tcfg, m, [3, 5], 16)
    logits = np.random.default_rng(2).standard_normal((2, 64)).astype(
        np.float32)
    active = np.array([True, True])
    jt, jl, jm, _ = J.decode_chunk_multi(
        jp, jm, jnp.asarray(logits), jnp.zeros((2, 2), jnp.uint32),
        jnp.asarray(active), jcfg, steps=6)
    rng = {"seed": torch.zeros(2, dtype=torch.long),
           "counter": torch.zeros(2, dtype=torch.long)}
    tt, tl, tm, _ = T.decode_chunk_multi(
        m, tm, torch.from_numpy(logits), rng, torch.from_numpy(active), tcfg,
        steps=6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(tl, jl)


# -- transformer functions at bfloat16 ------------------------------------------

# bf16 keeps 8 significant bits; JAX (XLA on the CPU) and torch round the
# bf16 intermediates (norms, rope, silu, the products) at other points,
# so over two layers the logits drift by a few bf16 ulps of the largest
# logit: 2**-5 of it is 4 ulps at the top of its binade
BF16_TOL = 2.0 ** -5


def test_bf16_teacher_forced_logits_within_tolerance():
    """Prefill then 12 decode steps, both fed JAX's greedy tokens: each
    step's logits within BF16_TOL of the largest, and the port's argmax
    equal to JAX's wherever JAX's top-2 margin exceeds that bound."""
    jcfg, jp, tcfg, m = _pair("bfloat16", seed=3)
    prompts = [np.array([3, 11, 25, 40, 7], np.int32),
               np.array([9, 8, 7], np.int32)]
    checked = 0
    for p in prompts:
        jl, jc = J.prefill(jp, J.init_cache(jcfg, 1, 24),
                           jnp.asarray(p[None]), jcfg)
        tl, tc = T.prefill(m, T.init_cache(tcfg, 1, 24), _t(p[None]), tcfg)
        for _ in range(12):
            want, got = np.asarray(jl)[0], tl[0].numpy()
            tol = BF16_TOL * np.abs(want).max()
            assert np.abs(got - want).max() <= tol
            top2 = np.sort(want)[-2:]
            if top2[1] - top2[0] > tol:
                assert got.argmax() == want.argmax()
                checked += 1
            tok = np.array([want.argmax()], np.int32)
            jl, jc = J.decode_step(jp, jc, jnp.asarray(tok), jcfg)
            tl, tc = T.decode_step(m, tc, _t(tok), tcfg)
    assert checked >= 12


# -- sampling -------------------------------------------------------------------

def _jax_candidates(logits, top_k, top_p, draws=2048):
    """JAX's candidate set, read from JAX's own sampler: at a huge
    temperature every candidate is (nearly) equally likely and the rest
    never drawn, so 2048 draws a row find them all."""
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    rows = []
    for row in logits:
        lg = jnp.broadcast_to(jnp.asarray(row), (draws, row.size))
        toks = np.asarray(J.sample_logits(keys, lg, 1e30, top_k=top_k,
                                          top_p=top_p))
        rows.append(set(toks.tolist()))
    return rows


@pytest.mark.parametrize("top_k,top_p", [(8, 1.0), (0, 0.9), (8, 0.8),
                                         (0, 0.0), (1, 1.0), (3, 0.5)])
def test_candidate_sets_equal_jax(top_k, top_p):
    logits = (np.random.default_rng(top_k + int(top_p * 10))
              .standard_normal((4, 64)) * 3).astype(np.float32)
    port = T.candidates(torch.from_numpy(logits), top_k, top_p)
    want = _jax_candidates(logits, top_k, top_p)
    got = [set(np.flatnonzero(np.isfinite(r)).tolist()) for r in port.numpy()]
    assert got == want
    # the port's own draws at the same temperature stay inside and cover
    n = 2048
    rng = {"seed": torch.full((n,), 7), "counter": torch.arange(n)}
    for row, cand in zip(logits, want):
        toks = T.sample_logits(torch.from_numpy(row).expand(n, -1), 1e30,
                               top_k, top_p, rng)
        assert set(toks.tolist()) == cand


def test_uniform_noise_is_per_stream_and_uniform():
    """A stream's noise depends on its (seed, counter) only, not on the
    rows beside it; values lie in (0, 1) with the mean and spread of a
    uniform."""
    seed = torch.tensor([3, 3, 9, 1 << 40])
    counter = torch.tensor([0, 1, 0, 5])
    u = T.uniform_noise(seed, counter, 4096)
    alone = T.uniform_noise(seed[2:3], counter[2:3], 4096)
    assert torch.equal(u[2], alone[0])
    assert not torch.equal(u[0], u[1])
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(u.std()) - 12 ** -0.5) < 0.01


# -- the filter -----------------------------------------------------------------

def mk(custom, model=ZOO):
    f = find_filter("llm")()
    f.open(FilterProperties(model_files=(model,), custom_properties=custom,
                            accelerators=(Accelerator.CPU,)))
    return f


def collect(f, prompts, per_stream, timeout=90.0):
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


def gen(custom, prompts, per_stream, timeout=90.0):
    f = mk(custom)
    try:
        return collect(f, prompts, per_stream, timeout)
    finally:
        f.close()


def _gen_tokens(custom: str, prompt: np.ndarray):
    fw = mk(custom)
    out = fw.invoke([prompt])[0]
    stats = dict(fw.stats.snapshot())
    fw.close()
    return out, stats


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


@pytest.fixture
def lm_files(tmp_path):
    """One float32 weight set as a ``get_lm()`` file for each package."""
    jcfg = J.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                       dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jax.device_get(
        J.init_params(jcfg, jax.random.PRNGKey(5))))
    flat = {k: tree[k] for k in ("embed", "head", "ln_f")}
    for i, layer in enumerate(tree["layers"]):
        flat.update({f"{i}.{n}": a for n, a in layer.items()})
    npz = str(tmp_path / "gpt.npz")
    np.savez(npz, **flat)
    files = {}
    for pkg, imports, dtype in (
            ("jax", "import jax.numpy as jnp\nfrom nnstreamer_tpu.models."
             "transformer import GPTConfig", "jnp.float32"),
            ("port", "import torch\nfrom nnstreamer_tpu_torch.models."
             "transformer import GPTConfig", "torch.float32")):
        path = tmp_path / f"lm_{pkg}.py"
        path.write_text(LM_PY.format(imports=imports, npz=npz, dtype=dtype))
        files[pkg] = str(path)
    return files


PROMPTS4 = [np.array([1, 2, 3, 4, 5], np.int32), np.array([7, 8, 9], np.int32),
            np.array([3, 3, 3], np.int32),
            np.array([10, 11, 12, 13, 14, 15, 16, 17, 18], np.int32)]


def test_filter_greedy_tokens_equal_jax_f32(lm_files):
    """16 greedy tokens on 4 prompts through each package's llm filter,
    same float32 weights: the port's sync invoke and its n_parallel=4
    chunk=4 scheduler both emit the JAX filter's tokens."""
    custom = "max_tokens:16,max_len:32"
    jfw = jax_find("llm")()
    jfw.open(JaxProps(model_files=(lm_files["jax"],),
                      custom_properties=custom))
    want = [jfw.invoke([p])[0].tolist() for p in PROMPTS4]
    jfw.close()
    fw = mk(custom, lm_files["port"])
    assert fw._cfg.dtype == torch.float32
    assert [fw.invoke([p])[0].tolist() for p in PROMPTS4] == want
    fw.close()
    fw = mk(custom + ",n_parallel:4,chunk:4", lm_files["port"])
    got = collect(fw, PROMPTS4, 16)
    fw.close()
    assert [got[i] for i in range(4)] == want


def test_py_model_takes_a_port_module(tmp_path):
    """get_lm() may return the port's GPT module itself."""
    path = tmp_path / "lm.py"
    path.write_text(
        "import torch\nfrom nnstreamer_tpu_torch.models import transformer "
        "as T\n\ndef get_lm():\n    cfg = T.GPTConfig(vocab=64, d_model=32,"
        " n_heads=4, n_layers=2)\n    return T.init_params(cfg, "
        "torch.Generator().manual_seed(0)), cfg\n")
    fw = mk("max_tokens:4", str(path))
    assert fw.invoke([np.array([1, 2], np.int32)])[0].shape == (4,)
    fw.close()


def test_out_of_vocab_and_oversized_prompts_are_refused_on_the_host():
    fw = mk("max_tokens:4,n_parallel:2,max_len:8")
    with pytest.raises(ValueError, match="vocabulary"):
        fw.invoke_async([np.array([1, 64], np.int32)])
    with pytest.raises(ValueError, match="vocabulary"):
        fw.invoke([np.array([-1, 2], np.int32)])
    with pytest.raises(ValueError, match="max_len"):
        fw.invoke_async([np.arange(9, dtype=np.int32)])
    with pytest.raises(ValueError, match="empty"):
        fw.invoke_async([np.zeros(0, np.int32)])
    fw.close()


def test_deferred_model_options_raise_not_ported():
    """The mesh fields are ported: a seq axis without a mesh runs the
    dense attention, and an unknown scheme is refused at the forward,
    as in JAX. A gguf file is still refused."""
    cfg = T.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=1,
                      seq_axis="seq", dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.arange(8)[None] % 64
    plain = dataclasses.replace(cfg, seq_axis=None)
    assert torch.equal(T.forward(params, tokens, cfg),
                       T.forward(params, tokens, plain))
    with pytest.raises(ValueError, match="unknown seq_scheme"):
        T.forward(params, tokens,
                  dataclasses.replace(cfg, seq_scheme="bogus"))
    with pytest.raises(NotImplementedError, match="gguf"):
        mk("", "model.gguf")


def test_zoo_gpt_logit_model_matches_the_jax_entry():
    """zoo://gpt through torch-cuda on the CPU: int32 [S] -> f32 [S, V],
    the JAX entry's caps; on the JAX weights the logits agree."""
    from nnstreamer_tpu.models import zoo as jax_zoo
    from nnstreamer_tpu_torch.models import zoo
    spec = dict(vocab="64", d_model="32", n_heads="4", n_layers="2",
                seq="8")
    apply_fn, module, in_info, out_info = zoo.build("gpt", **spec)
    japply, jparams, jin, jout = jax_zoo.build("gpt", **spec)
    assert (str(in_info), str(out_info)) == (str(jin), str(jout))
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    module.load_state_dict(gpt_params_from_jax(tree))
    toks = np.arange(8, dtype=np.int32)
    got = apply_fn(module, torch.from_numpy(toks))
    want = np.asarray(japply(jparams, jnp.asarray(toks)))
    assert got.shape == (8, 64)
    # bf16 weights and activations: the teacher-forced bound
    assert np.abs(got.numpy() - want).max() <= BF16_TOL * np.abs(want).max()


# -- mirrors of tests/test_llm.py -------------------------------------------------

def test_llm_sync_generation():
    fw = mk("max_tokens:5")
    out = fw.invoke([np.array([1, 2, 3], np.int32)])
    assert out[0].shape == (5,)
    assert out[0].dtype == np.int32
    fw.close()


def test_llm_greedy_is_deterministic():
    outs = [_gen_tokens("max_tokens:6", np.array([5, 9], np.int32))[0]
            for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])


def _wait(pipe, n, timeout=60):
    deadline = time.monotonic() + timeout
    while len(pipe["out"].buffers) < n and time.monotonic() < deadline:
        time.sleep(0.02)


def test_llm_async_token_stream_pipeline():
    """1 prompt in -> N token buffers out through tensor_filter
    invoke-async (the generative pipeline shape)."""
    pipe = pt.parse_launch(
        f'appsrc name=in caps="{CAPS}" '
        f'! tensor_filter framework=llm model="{ZOO}" {CPU} '
        'invoke-async=true custom="max_tokens:4" invoke-dynamic=true '
        '! appsink name=out')
    pipe.start()
    pipe["in"].push_buffer(pt.Buffer.from_arrays(
        [np.array([1, 2, 3, 4], np.int32)]))
    _wait(pipe, 4)
    pipe["in"].end_stream()
    pipe.stop()
    out = pipe["out"].buffers
    assert len(out) == 4          # one buffer per generated token
    for b in out:
        assert b.chunks[0].shape == (1,)


def test_async_two_inflight_prompts_keep_their_pts():
    """Two prompts in flight: every token buffer carries ITS prompt's
    pts and the single-stream greedy tokens, with n_parallel decode."""
    pipe = pt.parse_launch(
        f'appsrc name=in caps="{CAPS}" '
        f'! tensor_filter framework=llm model="{ZOO}" {CPU} '
        'invoke-async=true custom="max_tokens:4,n_parallel:2,max_len:32" '
        'invoke-dynamic=true ! appsink name=out')
    pipe.start()
    p1 = np.array([1, 2, 3, 4], np.int32)
    p2 = np.array([9, 8, 7, 6], np.int32)
    pipe["in"].push_buffer(pt.Buffer.from_arrays([p1], pts=1000))
    pipe["in"].push_buffer(pt.Buffer.from_arrays([p2], pts=2000))
    _wait(pipe, 8)
    pipe["in"].end_stream()
    pipe.stop()
    out = pipe["out"].buffers
    assert len(out) == 8
    by_pts = {1000: [], 2000: []}
    for b in out:
        assert b.pts in by_pts, f"token frame with foreign pts {b.pts}"
        by_pts[b.pts].append(int(np.asarray(b.chunks[0].host())[0]))
    ref = mk("max_tokens:4,max_len:32")
    np.testing.assert_array_equal(by_pts[1000], ref.invoke([p1])[0])
    np.testing.assert_array_equal(by_pts[2000], ref.invoke([p2])[0])
    ref.close()


def test_batched_decode_shares_dispatches():
    """n_parallel=2: two streams decode in shared steps (decode
    dispatches ~ max_tokens, not streams x tokens), each matching its
    single-stream greedy reference."""
    fw = mk("max_tokens:6,n_parallel:2,max_len:32")
    p1 = np.array([1, 2, 3], np.int32)
    p2 = np.array([40, 41, 42, 43, 44], np.int32)
    got = collect(fw, [p1, p2], 6)
    n_decode = fw.stats["decode_dispatches"]
    fw.close()
    assert n_decode <= 7, n_decode
    ref = mk("max_tokens:6,max_len:32")
    np.testing.assert_array_equal(got[0], ref.invoke([p1])[0])
    np.testing.assert_array_equal(got[1], ref.invoke([p2])[0])
    ref.close()


def test_batched_max_len_boundary_matches_single():
    """A stream that hits max_len emits the same tokens batched as
    single-stream (emit-then-check ordering)."""
    prompt = np.arange(1, 16, dtype=np.int32)  # 15 tokens, max_len 16
    want, _ = _gen_tokens("max_tokens:8,max_len:16", prompt)
    fw = mk("max_tokens:8,max_len:16,n_parallel:2")
    got = []
    fw.set_async_dispatcher(lambda o, ctx=None: got.append(int(o[0][0])))
    fw.invoke_async([prompt], ctx=None)
    deadline = time.monotonic() + 60
    while len(got) < len(want) and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.2)  # would catch any EXTRA token beyond the reference
    fw.close()
    np.testing.assert_array_equal(got, want)


def test_batched_sampling_reproducible_per_stream():
    """temperature>0 with n_parallel: each stream owns its seed and
    counter, so its tokens match the n_parallel=1 path."""
    opts = "max_tokens:5,temperature:0.8,seed:3,max_len:32"
    p1 = np.array([1, 2, 3], np.int32)
    p2 = np.array([7, 8], np.int32)
    want1, _ = _gen_tokens(opts, p1)
    want2, _ = _gen_tokens(opts, p2)
    got = gen(opts + ",n_parallel:2", [p1, p2], 5)
    np.testing.assert_array_equal(got[0], want1)
    np.testing.assert_array_equal(got[1], want2)


def test_decode_step_multi_matches_single():
    """decode_step_multi with per-slot positions reproduces two
    independent decode_step loops (slots at different depths)."""
    _, _, cfg, m = _pair(d_ff=64)
    prompts = [torch.tensor([[3, 11, 25]]), torch.tensor([[40, 7, 19, 22, 5]])]
    refs = []
    for p in prompts:
        logits, cache = T.prefill(m, T.init_cache(cfg, 1, 16), p, cfg)
        toks = []
        for _ in range(4):
            t = torch.argmax(logits, -1)
            toks.append(int(t[0]))
            logits, cache = T.decode_step(m, cache, t, cfg)
        refs.append(toks)
    mcache = T.init_cache_multi(cfg, 2, 16)
    logits = torch.zeros(2, cfg.vocab)
    for slot, p in enumerate(prompts):
        l1, c1 = T.prefill(m, T.init_cache(cfg, 1, 16), p, cfg)
        T.cache_insert(mcache, c1, slot)
        logits[slot] = l1[0]
    outs = [[], []]
    active = torch.ones(2, dtype=torch.bool)
    for _ in range(4):
        tok = torch.argmax(logits, -1)
        for slot in range(2):
            outs[slot].append(int(tok[slot]))
        logits, mcache = T.decode_step_multi(m, mcache, tok, active, cfg)
    assert outs == refs


def test_llamacpp_alias(monkeypatch):
    """The two names are default aliases of the configuration, as
    ``torch`` is; a user's NNS_TPU_FILTER_ALIASES still remaps them."""
    assert find_filter("llamacpp").NAME == "llm"
    assert find_filter("llama2c").NAME == "llm"
    monkeypatch.setenv("NNS_TPU_FILTER_ALIASES", "llamacpp=custom-easy")
    assert find_filter("llamacpp").NAME == "custom-easy"
    assert find_filter("llama2c").NAME == "llm"


def test_prefill_single_dispatch_matches_sequential():
    """One prefill pass, then one decode step a token: the same tokens
    as a sequential one-token prefill through decode_step."""
    prompt = np.array([3, 11, 25, 40, 7], np.int32)
    fw = mk("max_tokens:6")
    fast = fw.invoke([prompt])[0]
    assert fw.stats["prefill_dispatches"] == 1
    assert fw.stats["decode_dispatches"] == 5  # max_tokens - 1
    cfg, m = fw._cfg, fw._params
    cache = T.init_cache(cfg, 1, len(prompt) + 6)
    logits = None
    for t in prompt:
        logits, cache = T.decode_step(m, cache, torch.tensor([int(t)]), cfg)
    slow = []
    for _ in range(6):
        tok = torch.argmax(logits, -1)
        slow.append(int(tok[0]))
        logits, cache = T.decode_step(m, cache, tok, cfg)
    fw.close()
    np.testing.assert_array_equal(fast, np.asarray(slow, np.int32))


def test_prefill_cache_matches_decode_loop():
    _, _, cfg, m = _pair(d_ff=64)
    tokens = torch.tensor([[3, 11, 25, 40, 7, 19]])
    fast_logits, fast_cache = T.prefill(m, T.init_cache(cfg, 1, 8), tokens,
                                        cfg)
    cache = T.init_cache(cfg, 1, 8)
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = T.decode_step(m, cache, tokens[:, i], cfg)
    np.testing.assert_allclose(fast_logits.numpy(), logits.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(fast_cache["k"].numpy(), cache["k"].numpy(),
                               rtol=2e-3, atol=2e-3)
    assert int(fast_cache["index"]) == tokens.shape[1]


def test_prefill_length_bucketing_reuses_compilation():
    """Prompts of different lengths (2-D ones flattened before the
    overflow check) share one decode state: every prefill is one pass
    over the same max_len window."""
    fw = mk("max_tokens:3,max_len:32")
    for prompt in (np.array([1, 2, 3, 4, 5], np.int32),
                   np.array([9, 8, 7, 6, 5, 4, 3], np.int32),
                   np.array([[2, 4, 6, 8, 10, 12]], np.int32)):  # 2-D
        out = fw.invoke([prompt])
        assert out[0].shape == (3,)
    assert list(fw._single) == [32]
    assert fw.stats["prefill_dispatches"] == 3
    fw.close()


def test_chunked_greedy_matches_per_token():
    """chunk:K emits chunk:1's tokens with K-fold fewer dispatches."""
    p = np.array([3, 1, 4], np.int32)
    ref, ref_stats = _gen_tokens("max_tokens:12,max_len:32", p)
    got, got_stats = _gen_tokens("max_tokens:12,max_len:32,chunk:4", p)
    np.testing.assert_array_equal(got, ref)
    assert ref_stats["decode_dispatches"] == 11   # per-token loop
    assert got_stats["decode_dispatches"] == 3    # ceil(12/4) chunks


def test_chunked_sampling_matches_per_token():
    p = np.array([7, 7], np.int32)
    ref, _ = _gen_tokens("max_tokens:10,max_len:32,temperature:0.8,seed:3", p)
    got, _ = _gen_tokens(
        "max_tokens:10,max_len:32,temperature:0.8,seed:3,chunk:4", p)
    np.testing.assert_array_equal(got, ref)


def test_chunked_max_len_cutoff_matches_per_token():
    p = np.array([2, 5, 6], np.int32)
    ref, _ = _gen_tokens("max_tokens:16,max_len:8", p)
    got, _ = _gen_tokens("max_tokens:16,max_len:8,chunk:4", p)
    np.testing.assert_array_equal(got, ref)
    assert len(ref) == 6


def test_chunked_batched_decode_matches_reference():
    fw = mk("max_tokens:8,n_parallel:2,max_len:32,chunk:4")
    p1 = np.array([1, 2, 3], np.int32)
    p2 = np.array([40, 41, 42, 43, 44], np.int32)
    got = collect(fw, [p1, p2], 8)
    n_decode = fw.stats["decode_dispatches"]
    fw.close()
    assert n_decode <= 4, n_decode
    np.testing.assert_array_equal(
        got[0], _gen_tokens("max_tokens:8,max_len:32", p1)[0])
    np.testing.assert_array_equal(
        got[1], _gen_tokens("max_tokens:8,max_len:32", p2)[0])


def test_chunked_batched_sampling_reproducible():
    opts = "max_tokens:6,max_len:32,temperature:0.7,seed:5"
    p1 = np.array([11, 12], np.int32)
    p2 = np.array([21, 22, 23], np.int32)
    got = gen(opts + ",n_parallel:2,chunk:4", [p1, p2], 6)
    np.testing.assert_array_equal(got[0], _gen_tokens(opts, p1)[0])
    np.testing.assert_array_equal(got[1], _gen_tokens(opts, p2)[0])


@pytest.mark.parametrize("extra", ["", ",temperature:0.7,seed:5"])
def test_chunked_batched_max_len_cutoff_matches_single(extra):
    """A stream that fills its cache emits the single-stream tokens
    while a deeper co-resident stream keeps decoding past that point."""
    p1 = np.array([2, 5, 6], np.int32)        # fills max_len 8 first
    p2 = np.array([1], np.int32)              # keeps going afterwards
    ref1, _ = _gen_tokens("max_tokens:16,max_len:8" + extra, p1)
    ref2, _ = _gen_tokens("max_tokens:16,max_len:8" + extra, p2)
    assert len(ref1) == 6 and len(ref2) == 8
    fw = mk("max_tokens:16,max_len:8,n_parallel:2,chunk:4" + extra)
    got, done = {}, set()

    def dispatch(outputs, ctx=None):
        got.setdefault(ctx, []).append(int(outputs[0][0]))
        if len(got[ctx]) == (6 if ctx == "a" else 8):
            done.add(ctx)

    fw.set_async_dispatcher(dispatch)
    fw.invoke_async([p1], ctx="a")
    fw.invoke_async([p2], ctx="b")
    deadline = time.monotonic() + 60
    while len(done) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.2)  # catch any EXTRA tokens beyond the references
    fw.close()
    np.testing.assert_array_equal(got["a"], ref1)
    np.testing.assert_array_equal(got["b"], ref2)


def test_top_k_1_equals_greedy():
    p = np.array([2, 9, 4], np.int32)
    greedy, _ = _gen_tokens("max_tokens:10,max_len:32", p)
    topk1, _ = _gen_tokens(
        "max_tokens:10,max_len:32,temperature:0.9,seed:7,top_k:1", p)
    np.testing.assert_array_equal(topk1, greedy)


def test_tiny_top_p_equals_greedy():
    p = np.array([5, 5, 5], np.int32)
    greedy, _ = _gen_tokens("max_tokens:8,max_len:32", p)
    nucleus, _ = _gen_tokens(
        "max_tokens:8,max_len:32,temperature:1.3,seed:2,top_p:0.0001", p)
    np.testing.assert_array_equal(nucleus, greedy)


def test_chunked_sampling_with_topk_topp_matches_per_token():
    p = np.array([7, 1], np.int32)
    ref, _ = _gen_tokens(
        "max_tokens:10,max_len:32,temperature:0.8,seed:3,top_k:8,top_p:0.9",
        p)
    got, _ = _gen_tokens(
        "max_tokens:10,max_len:32,temperature:0.8,seed:3,top_k:8,"
        "top_p:0.9,chunk:4", p)
    np.testing.assert_array_equal(got, ref)


def test_sample_logits_respects_top_k():
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32))
    top4 = np.argsort(logits.numpy(), axis=-1)[:, -4:]
    for seed in range(5):
        rng = {"seed": torch.arange(4) + seed * 10,
               "counter": torch.zeros(4, dtype=torch.long)}
        toks = T.sample_logits(logits, 1.5, top_k=4, rng=rng).numpy()
        for row in range(4):
            assert toks[row] in top4[row], (row, toks[row])


def test_sample_logits_respects_top_p():
    logits = torch.zeros(2, 32)
    logits[:, 5] = 8.0
    rng = {"seed": torch.arange(2), "counter": torch.zeros(2,
                                                            dtype=torch.long)}
    toks = T.sample_logits(logits, 2.0, top_p=0.5, rng=rng)
    np.testing.assert_array_equal(toks.numpy(), [5, 5])


def test_top_p_zero_degrades_to_greedy():
    p = np.array([4, 2], np.int32)
    greedy, _ = _gen_tokens("max_tokens:8,max_len:32", p)
    z, _ = _gen_tokens(
        "max_tokens:8,max_len:32,temperature:1.0,seed:1,top_p:0", p)
    np.testing.assert_array_equal(z, greedy)


def test_nucleus_formed_before_temperature():
    """The top_p set comes from the unscaled distribution, so a huge
    temperature cannot widen it."""
    logits = torch.full((1, 32), -10.0)
    logits[0, 3] = logits[0, 11] = 5.0
    for seed in range(12):
        rng = {"seed": torch.tensor([seed]), "counter": torch.tensor([0])}
        tok = int(T.sample_logits(logits, 50.0, top_p=0.9, rng=rng)[0])
        assert tok in (3, 11), tok


def test_llm_loads_trained_weights_from_checkpoint(tmp_path):
    """zoo://gpt?params_dir=... loads the weights tensor_trainer saves
    (the port's state_dict file; the JAX test's orbax tree, here the
    same JAX init_params(PRNGKey(42)) tree converted and saved with the
    port's save_params): the served weights are that tree's, bitwise,
    generation differs from the seed-0 init and is reproducible across
    opens. A missing directory raises instead of serving the init."""
    from nnstreamer_tpu_torch.trainers import save_params
    cfg = J.GPTConfig(vocab=64, d_model=32, n_heads=4, n_layers=2)
    trained = jax.tree.map(np.asarray, jax.device_get(
        J.init_params(cfg, jax.random.PRNGKey(42))))
    want = gpt_params_from_jax(trained)
    ckpt = str(tmp_path / "gpt-ckpt")
    save_params(ckpt, want)
    p = np.array([7, 3, 1], np.int32)
    f = mk("max_tokens:8,max_len:32")
    out_random = f.invoke([p])[0]
    f.close()
    fw_tokens = []
    for _ in range(2):
        f = mk("max_tokens:8,max_len:32", f"{ZOO}&params_dir={ckpt}")
        fw_tokens.append(f.invoke([p])[0])
        served = {k: v.float() for k, v in f._params.state_dict().items()}
        f.close()
    assert sorted(served) == sorted(want)
    for k, v in want.items():
        assert torch.equal(served[k], v.to(torch.bfloat16).float()), k
    np.testing.assert_array_equal(fw_tokens[0], fw_tokens[1])
    assert not np.array_equal(fw_tokens[0], out_random)
    with pytest.raises(FileNotFoundError):
        mk("max_tokens:8,max_len:32", f"{ZOO}&params_dir={tmp_path}/none")


# -- mirrors of tests/test_llm_disagg.py: the paged transformer ---------------------

def _tiny(dtype="bfloat16"):
    """test_llm_disagg.py's TestPagedTransformer model (bf16, d 16)."""
    return _pair(dtype, seed=0, vocab=32, d_model=16, n_heads=2)


def test_paged_decode_bit_identical_to_contiguous():
    _, _, cfg, m = _tiny()
    bs, nb, max_len, n = 4, 16, 32, 2
    prompts = [torch.tensor([1, 2, 3, 4, 5]), torch.tensor([7, 8, 9])]
    cache = T.init_cache_multi(cfg, n, max_len)
    pool = T.init_kv_pool(cfg, nb, bs)
    w = max_len // bs
    table = torch.full((n, w), nb)
    index = torch.zeros(n, dtype=torch.long)
    logits = torch.zeros(n, cfg.vocab)
    for slot, prompt in enumerate(prompts):
        l1, c1 = T.prefill(m, T.init_cache(cfg, 1, max_len), prompt[None],
                           cfg)
        T.cache_insert(cache, c1, slot)
        blocks = torch.arange(slot * w, (slot + 1) * w)
        sh = (cfg.n_layers, w, bs, cfg.n_heads, cfg.head_dim)
        T.pool_insert(pool, c1["k"][:, 0].reshape(sh),
                      c1["v"][:, 0].reshape(sh), blocks)
        table[slot] = blocks
        index[slot] = prompt.numel()
        logits[slot] = l1[0]
    lc = lp = logits
    for step in range(20):
        active = torch.tensor([True, step < 12])  # slot 1 retires early
        tok = torch.argmax(lc, -1)
        assert torch.equal(tok, torch.argmax(lp, -1))
        lc, cache = T.decode_step_multi(m, cache, tok, active, cfg)
        lp, pool, index = T.decode_step_paged(m, pool, table, index, tok,
                                              active, cfg, max_len=max_len)
        assert torch.equal(lc, lp)


def test_prefill_with_past_matches_full_prefill():
    """The suffix over a 12-row window (the past padded, as the filter
    pads it) gives the logits and suffix K/V of the whole prompt
    prefilled over the same window, bit for bit: each row sits at its
    absolute position."""
    _, _, cfg, m = _tiny()
    toks = torch.arange(1, 13)              # 12 tokens, split at 8
    window = 12
    empty = torch.zeros(cfg.n_layers, window, cfg.n_heads, cfg.head_dim,
                        dtype=cfg.dtype)
    lf, kf, vf = T.prefill_with_past(m, empty, empty, 0, toks[None], cfg)
    past_k, past_v = empty.clone(), empty.clone()
    past_k[:, :8], past_v[:, :8] = kf[:, :8], vf[:, :8]
    suffix = torch.zeros(window, dtype=torch.long)
    suffix[:4] = toks[8:]
    ls, sk, sv = T.prefill_with_past(m, past_k, past_v, 8, suffix[None],
                                     cfg, true_len=4)
    assert torch.equal(lf, ls)
    assert torch.equal(kf[:, 8:12], sk[:, :4])
    assert torch.equal(vf[:, 8:12], sv[:, :4])


def test_pool_insert_gather_roundtrip():
    _, _, cfg, _ = _tiny()
    bs, nb = 4, 8
    pool = T.init_kv_pool(cfg, nb, bs)
    rng = np.random.default_rng(0)
    kb = torch.from_numpy(rng.standard_normal(
        (cfg.n_layers, 2, bs, cfg.n_heads, cfg.head_dim)).astype(np.float32))
    vb = torch.from_numpy(rng.standard_normal(kb.shape).astype(np.float32))
    T.pool_insert(pool, kb, vb, torch.tensor([5, 2]))
    k, _ = T.pool_gather(pool, torch.tensor([5, 2]))
    assert torch.equal(k.reshape(kb.shape), kb.to(cfg.dtype))


def test_out_of_bounds_write_is_dropped():
    """An inactive lane's guarded write lands in the discard block NB:
    the allocator's blocks are untouched and the position holds."""
    _, _, cfg, m = _tiny()
    bs, nb, max_len = 4, 4, 16
    pool = T.init_kv_pool(cfg, nb, bs)
    before = pool["k"][:, :nb].clone()
    table = torch.zeros(1, max_len // bs, dtype=torch.long)
    _, pool, index = T.decode_step_paged(
        m, pool, table, torch.tensor([3]), torch.tensor([1]),
        torch.tensor([False]), cfg, max_len=max_len)
    assert torch.equal(pool["k"][:, :nb], before)
    assert int(index[0]) == 3


# -- mirrors of tests/test_llm_disagg.py: the paged filter ------------------------

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [3, 3, 3],
           [10, 11, 12, 13, 14, 15, 16, 17, 18]]


def _parity(base, paged_extra):
    a = gen(base, PROMPTS, 10)
    fp = mk(base + ",paged:true" + paged_extra)
    b = collect(fp, PROMPTS, 10)
    # the paged backend must actually have run
    assert fp._paged
    d = fp._pool_mgr.stats_dict()
    assert d["blocks_used"] + d["blocks_free"] == fp._pool_mgr.n_blocks
    assert d["prefix_hits"] + d["prefix_misses"] + d["blocks_used"] > 0
    assert fp.stats["decode_dispatches"] > 0
    fp.close()
    assert a == b, f"paged diverged from contiguous\n{a}\n{b}"


def test_greedy_byte_identical():
    _parity("max_tokens:10,n_parallel:4,max_len:64", ",block_size:8")


def test_temperature_byte_identical():
    _parity("max_tokens:10,n_parallel:4,max_len:64,"
            "temperature:0.7,seed:11,top_k:8", ",block_size:4")


def test_chunked_byte_identical():
    _parity("max_tokens:10,n_parallel:4,max_len:64,"
            "temperature:0.5,seed:2,chunk:4", ",block_size:8")


def test_prefix_cache_hits_and_exact_tokens():
    pref = list(range(1, 25))                 # 3 full blocks @ bs=8
    prompts = [pref + [30, 31], pref + [40, 41, 42]]
    base = ("max_tokens:8,n_parallel:2,max_len:64,seed:3,"
            "block_size:8,paged:true")
    ref = gen(base + ",prefix_cache:false", prompts, 8)
    f = mk(base + ",prefix_cache:true")
    got = collect(f, prompts, 8)
    assert ref == got
    s = f.stats.snapshot()
    assert s["prefill_cached_tokens"] == 24
    assert s["prefill_computed_tokens"] == 26 + 3
    assert f._pool_mgr.stats_dict()["prefix_hits"] == 3
    f.close()


def test_prefix_hit_runs_fewer_prefill_rows():
    """Prefill pads the computed tokens to a power-of-two bucket of at
    least 8 rows, as the JAX filter does, so a prefix hit runs fewer
    rows than the miss that computes the whole prompt, and the tokens
    stay those of the prefix-cache-off run."""
    pref = list(range(1, 25))                 # 3 full blocks @ bs=8
    prompts = [pref + [30, 31], pref + [40, 41, 42]]
    base = ("max_tokens:6,n_parallel:2,max_len:64,"
            "block_size:8,paged:true")
    rows = {}
    toks = {}
    for on in ("false", "true"):
        f = mk(base + ",prefix_cache:" + on)
        try:
            toks[on] = collect(f, prompts, 6)
            rows[on] = f.stats["prefill_rows"]
        finally:
            f.close()
    assert toks["true"] == toks["false"]
    assert rows["false"] == 32 + 32           # 26 and 27 tokens
    assert rows["true"] == 32 + 8             # the hit computes 3


def test_prefill_rows_follow_the_prompt_bucket():
    for plen, want in ((1, 8), (5, 8), (8, 8), (9, 16), (17, 32)):
        _, stats = _gen_tokens("max_tokens:2,max_len:64",
                               np.arange(1, plen + 1, dtype=np.int32))
        assert stats["prefill_rows"] == want, plen
    # the bucket never passes max_len
    _, stats = _gen_tokens("max_tokens:2,max_len:20",
                           np.arange(1, 18, dtype=np.int32))
    assert stats["prefill_rows"] == 20


def test_divergent_prompt_misses_cache():
    pref = list(range(1, 17))
    prompts = [pref + [30], [60] + pref[1:] + [30]]  # differ at token 0
    f = mk("max_tokens:4,n_parallel:2,max_len:64,seed:0,"
           "block_size:8,paged:true,prefix_cache:true")
    try:
        collect(f, prompts, 4)
        assert f.stats["prefill_cached_tokens"] == 0
    finally:
        f.close()


def test_budget_constrained_admission_completes_all():
    """A pool that fits about one stream at a time: admission backs off
    through the requeue and still finishes every stream exactly."""
    base = "max_tokens:8,n_parallel:4,max_len:64,prefix_cache:false"
    a = gen(base, PROMPTS, 8)
    f = mk(base + ",paged:true,block_size:8,pool_blocks:5")
    b = collect(f, PROMPTS, 8, timeout=120.0)
    assert f._pool_mgr.stats_dict()["alloc_failures"] > 0, \
        "pool never filled: the backpressure path was not exercised"
    f.close()
    assert a == b


def test_decode_role_requires_parallel():
    """role:decode implies the paged pool, which backs the scheduler."""
    with pytest.raises(ValueError, match="n_parallel"):
        mk("role:decode")


def test_handoff_rejected_by_contiguous_backend():
    """The contiguous lanes cannot adopt shipped K/V."""
    f = mk("max_tokens:4,n_parallel:2,max_len:32")
    try:
        from nnstreamer_tpu_torch.filters.llm import _ContigBackend
        be = _ContigBackend(f, 2, 32)
        with pytest.raises(ValueError, match="paged"):
            be.admit_handoff(0, np.array([1], np.int32), {}, 4)
    finally:
        f.close()


BASE = "max_tokens:4,n_parallel:2,max_len:32,paged:true,block_size:8"


def _paged_backend(f):
    from nnstreamer_tpu_torch.filters.llm import _PagedBackend
    return _PagedBackend(f, 2, 32)


def test_admit_failure_releases_all_blocks():
    f = mk(BASE)
    try:
        be = _paged_backend(f)
        used0 = f._pool_mgr.stats_dict()["blocks_used"]

        def boom(*a, **k):
            raise RuntimeError("insert failed")

        be._insert_span = boom
        with pytest.raises(RuntimeError, match="insert failed"):
            be.admit(0, np.arange(1, 6, dtype=np.int32), 4)
        assert f._pool_mgr.stats_dict()["blocks_used"] == used0, \
            "failed admit leaked block refs"
    finally:
        f.close()


def test_handoff_failure_releases_all_blocks():
    """A failed handoff fold hands back every block it took."""
    f = mk(BASE + ",handoff_port:0")
    try:
        be = _paged_backend(f)
        used0 = f._pool_mgr.stats_dict()["blocks_used"]

        def boom(*a, **k):
            raise RuntimeError("insert failed")

        be._insert_span = boom
        prompt = np.arange(1, 7, dtype=np.int32)
        kv = {"prompt": prompt,
              "k": torch.zeros(2, 6, 4, 8, dtype=torch.bfloat16),
              "v": torch.zeros(2, 6, 4, 8, dtype=torch.bfloat16),
              "logits": np.zeros(64, np.float32)}
        with pytest.raises(RuntimeError, match="insert failed"):
            be.admit_handoff(0, prompt, kv, 4)
        assert f._pool_mgr.stats_dict()["blocks_used"] == used0, \
            "failed handoff fold leaked block refs"
    finally:
        f.close()


def test_pool_recovers_after_failed_admissions():
    f = mk(BASE + ",pool_blocks:4")
    try:
        be = _paged_backend(f)
        real_insert = be._insert_span
        state = {"boom": True}

        def flaky(*a, **k):
            if state["boom"]:
                raise RuntimeError("transient")
            return real_insert(*a, **k)

        be._insert_span = flaky
        for _ in range(4):      # > pool_blocks failures
            with pytest.raises(RuntimeError):
                be.admit(0, np.arange(1, 6, dtype=np.int32), 4)
        state["boom"] = False
        be.admit(0, np.arange(1, 6, dtype=np.int32), 4)
        assert be.blocks[0], "recovered admit did not seat blocks"
        be.free(0)
    finally:
        f.close()


def test_table_points_past_the_budget_at_the_discard_block():
    """Columns past a stream's blocks aim at the discard block, so a lane
    that runs past its budget inside a chunk writes nowhere another
    stream reads (the JAX table aims them at block 0)."""
    f = mk(BASE + ",pool_blocks:8")
    try:
        be = _paged_backend(f)
        # 5 prompt tokens + a budget of 3 fill exactly one block of 8
        be.seat(0, 5, be.admit(0, np.arange(1, 6, dtype=np.int32), 3), 0)
        assert be.table_np[0].tolist() == [be.blocks[0][0]] + [8] * 3
        before = be.pool["k"][:, :8].clone()
        for _ in range(8):                      # 5 past the budget
            be.step(torch.zeros(2, dtype=torch.long), np.array([True, False]))
        assert torch.equal(be.pool["k"][:, 1:8], before[:, 1:8])
        be.free(0)
    finally:
        f.close()


# -- pipelint ---------------------------------------------------------------------

@pytest.mark.parametrize("custom,fires", [
    ("n_parallel:4,paged:true", True),
    ("n_parallel:4,paged:true,pool_blocks:64", False),
    ("n_parallel:4", False),
    ("role:decode,n_parallel:4", True)])
def test_llm_decode_no_kv_budget_matches_the_jax_rule(custom, fires):
    from nnstreamer_tpu.analysis import analyze as nt_analyze
    from nnstreamer_tpu_torch.analysis import analyze
    desc = (f'appsrc caps="{CAPS}" ! tensor_filter name=f framework=llm '
            f'model="{ZOO}" invoke-async=true invoke-dynamic=true '
            f'custom="{custom}" ! appsink')

    def found(report):
        return {(f.rule, f.element, f.pad, f.severity.value)
                for f in report.findings
                if f.rule == "llm-decode-no-kv-budget"}

    got = found(analyze(pt.parse_launch(desc)))
    assert got == found(nt_analyze(nt.parse_launch(desc)))
    assert bool(got) == fires


# -- the port imports no JAX -------------------------------------------------------

def test_llm_modules_import_no_jax():
    """models.transformer, filters.kvpool and filters.llm import nothing
    of JAX or of the JAX package, in a fresh interpreter."""
    code = ("import sys; import nnstreamer_tpu_torch.models.transformer, "
            "nnstreamer_tpu_torch.filters.kvpool, "
            "nnstreamer_tpu_torch.filters.llm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', "
            "'nnstreamer_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
