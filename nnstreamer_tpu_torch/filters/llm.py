"""LLM generative filter: async token streaming on a KV-cache decode loop.

Port of ``nnstreamer_tpu/filters/llm.py`` (≙ ext/nnstreamer/tensor_filter/
tensor_filter_llamacpp.cc: 1 prompt in, N token frames out through the
async dispatcher, nnstreamer_filter_dispatch_output_async,
tensor_filter.c:1099-1170). Generation is the decode loop of
models/transformer.py on the filter's device: ``cuda:0`` unless
``accelerator`` asks for the CPU (``true:cpu`` or ``false``).

``model`` takes ``zoo://gpt?vocab=..&d_model=..&n_heads=..&n_layers=..
&seed=..`` (seeded random weights drawn on the filter's device) or a
``.py`` file whose ``get_lm()`` returns ``(params, cfg)``: ``cfg`` a
:class:`~..models.transformer.GPTConfig`, ``params`` a
:class:`~..models.transformer.GPT` or the JAX package's param tree as
numpy arrays (converted by ``gpt_params_from_jax``). ``.gguf`` is
claimed for auto-detection and refused. Custom properties
(``custom=key:value,...``): max_tokens, temperature (0 = greedy), top_k,
top_p, seed, max_len, n_parallel, chunk, the paged pool's paged,
block_size, pool_blocks, prefix_cache, and the phase split's role,
handoff, handoff_port, kv_precision.

``n_parallel:M`` (M > 1) turns on continuous batching: up to M prompts
share one decode step; prompts are admitted into slots as they free up.
``chunk:K`` runs K sample+decode rounds per dispatch and fetches the
[K, M] token block with one D2H copy on the copy stream
(``tensors/transfer.py``). ``paged:true`` backs the scheduler with a
block-paged KV arena (``block_size`` tokens a block, ``pool_blocks``
blocks; ``filters/kvpool.py`` allocates them), admission is
token-budgeted, and with ``prefix_cache:true`` (the default when paged)
a prompt whose block-aligned prefix is warm prefills only its suffix.

Decode state lives in place. A backend owns static tensors — the cache
lanes or the block arena, the positions, the logits, the block table,
the per-stream sampling seeds and counters and the [chunk, M] token
block — and on the card captures the decode step and the ``chunk``-step
loop as CUDA graphs that update them (a shorter tail chunk replays the
step graph); the prefill pass (``_Prefill``) is one more graph over
static token, position and K/V tensors. Each
capture goes through ``filters/executable.py`` ``capture_in_place``:
the element's graph pool, the device's one capture stream,
``thread_local`` capture mode (the scheduler thread captures while
pipeline threads run). The first call of each runs
eagerly and captures; later calls replay. ``compile_count`` counts the
captures. Only the tokens (per-token mode), the active mask and, after
an admission, the table are staged per step. On the CPU the same
functions run eagerly.

A prefill pads the computed tokens to a power-of-two bucket of at least
8 rows, and a cached prefix to its own, as JAX does (``_Prefill``, one
graph a bucket pair), so paged equals contiguous by construction (the
same shapes); a prefix hit runs fewer rows than the miss it replaces.
The paged table points the columns past a stream's
blocks at the arena's discard block (JAX points them at block 0), so a
lane that runs past its budget inside a chunk cannot write into a block
another stream owns.

Sampling: per-stream (seed, tokens drawn) counters and the hash noise of
``models/transformer.py`` (``sample_logits``), where JAX splits a
``PRNGKey(seed)`` per stream per step: a stream's tokens do not depend
on its neighbours, and chunked, per-token, paged and single-stream runs
draw the same tokens. The tokens are not JAX's; the candidate sets are.

Disaggregated serving, as in JAX: ``role:prefill|decode|both`` splits
the phases across replicas. A prefill replica runs only the prompt pass
and ships the prompt's K/V (``[L, T, H, Dh]``, off the card in one copy
batch) and last logits to ``handoff:host:port`` over the negotiated
KV_XFER link (``edge/kv.py``, ``kv_precision:none|bf16|fp16``; bf16 K/V
ride byte-exact under any precision, only f32 payloads are downcast). A
decode replica (implies ``paged``) listens on ``handoff_port:N`` (0 =
ephemeral; see ``handoff_port``) and folds each shipped stream into its
block arena on the scheduler thread (through pinned memory), seated
with the shipped sampling seed, so a split emits the monolithic stream.
Its KV_ACK answers ``adopted=False`` for a stream it cannot fold (no
paged pool, or more blocks than ``pool_blocks`` holds), where the JAX
filter acks such a stream and its scheduler drops it later.

``snapshot_state`` records each queued or running stream as ``{prompt,
emitted, remaining}`` (``None`` when there is none); ``restore_state``
stashes them, and a re-submitted prompt, or a re-shipped handoff, whose
digest (``checkpoint/state.py`` ``token_sha``) matches one continues
it: the emitted tokens join the prefill (over the shipped K/V, one
``prefill_with_past`` over the suffix) and only the rest of the budget
is generated. A re-adopted stream seats its sampling counter at the
number of tokens it emitted, so it continues the straight run's draws at
any temperature (JAX resumes with a fresh key: continuity for greedy
streams only). ``zoo://gpt?...&params_dir=<dir>`` serves trained
weights (``<dir>/params``, a ``state_dict`` file that ``tensor_trainer``
saves; trainers/checkpoint.py) in place of the seeded init. The
single-stream path (``n_parallel:1``) serialises its generations on one
decode state per ``max_len``, where JAX runs each on its own cache.
"""
from __future__ import annotations

import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import transformer as tfm
from ..tensors.info import TensorsInfo
from ..tensors.transfer import fetch_host, is_device_tensor, submit_fetch
from ..utils.atomic import Counters
from ..utils.log import logger
from .base import (FilterFramework, FilterProperties,
                   parse_custom_properties as _parse_custom)
from .executable import GraphPool, capture_in_place
from .registry import register_filter
from .torch_cuda_backend import device_for, full_f32_numerics

# default shared-cache length in n_parallel mode: the batched state is
# allocated once, so longer prompts need an explicit custom=max_len:N
DEFAULT_BATCH_MAX_LEN = 128

_TRUE = ("1", "true", "yes", "on")


def _ctx_of(ctx: Any):
    """The TraceContext riding on a Buffer-shaped invoke ctx, if any
    (plain correlation tokens, ints or strings, carry none)."""
    try:
        from ..obs import context as _obs_ctx
        return _obs_ctx.ctx_of(ctx)
    except Exception:  # noqa: BLE001 — tracing is best-effort by design
        return None


def _on_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A shipped host value (ndarray, or a CPU bf16 tensor) as a tensor
    of ``dtype`` on ``device``: on the card one H2D copy from pinned
    memory."""
    t = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype)


def _stage(dst: torch.Tensor, host: np.ndarray) -> None:
    """Copy a small host array into a static tensor on the current
    stream (through pinned memory on the card, without blocking)."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


def _host(t: torch.Tensor) -> np.ndarray:
    """The tensor's values on the host: one D2H copy on the copy stream
    for a CUDA tensor."""
    if is_device_tensor(t):
        return submit_fetch([t])[0].resolve()
    return t.numpy().copy()


class _PoolFull(Exception):
    """Paged admission backpressure: the KV pool cannot cover this
    stream right now; the scheduler requeues it."""


def _bucket(n: int, floor: int, cap: int) -> int:
    """The power of two at or above ``n`` (at least ``floor``), capped
    at ``cap``."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


class _Prefill:
    """The filter's prefill passes for one ``max_len``: a suffix over a
    past window (``prefill_with_past``), both padded to power-of-two
    buckets as the JAX filter pads them (the suffix to at least 8 rows,
    the past to the rows its cached blocks cover, none on a miss), with
    static inputs and outputs; on the card one graph a bucket pair,
    replayed for every prompt that falls in it. The windows are never
    cleared: rows at or past the suffix start are overwritten or masked,
    so stale (finite) rows read as zero-probability columns."""

    def __init__(self, filt: "LlmFilter", max_len: int):
        cfg, dev = filt._cfg, filt.device
        shape = (cfg.n_layers, max_len, cfg.n_heads, cfg.head_dim)
        self.f = filt
        self.max_len = max_len
        self.past_k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.past_v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.logits = torch.zeros(1, cfg.vocab, dtype=torch.float32,
                                  device=dev)
        self.tokens = torch.zeros(1, max_len, dtype=torch.long, device=dev)
        self.at = torch.zeros(2, dtype=torch.long, device=dev)  # p0, true_len
        self._graphs: Dict[Any, Any] = {}
        self._lock = threading.Lock()

    def _fn(self, rows: int, past: int) -> None:
        f = self.f
        logits, k, v = tfm.prefill_with_past(
            f._params, self.past_k[:, :past], self.past_v[:, :past],
            self.at[0], self.tokens[:, :rows], f._cfg, true_len=self.at[1])
        self.logits.copy_(logits)
        self.k[:, :rows].copy_(k)
        self.v[:, :rows].copy_(v)

    @torch.no_grad()
    def __call__(self, suffix: np.ndarray, past=None, past_len: int = 0):
        """(logits [1, V], K, V [L, rows, H, Dh]) of ``suffix`` after
        ``past_len`` rows of ``past`` ((k, v) [L, n, H, Dh] or None);
        ``rows`` is the suffix's bucket, its first ``suffix.size`` real."""
        rows = _bucket(suffix.size, 8, self.max_len)
        pb = _bucket(past_len, 1, self.max_len) if past_len else 0
        padded = np.zeros((1, rows), np.int64)
        padded[0, :suffix.size] = suffix
        with self._lock:
            if past is not None:
                n = past[0].shape[1]
                self.past_k[:, :n] = past[0]
                self.past_v[:, :n] = past[1]
            _stage(self.tokens[:, :rows], padded)
            _stage(self.at, np.array([past_len, suffix.size], np.int64))
            self.f._run(self._graphs, (rows, pb),
                        lambda: self._fn(rows, pb))
            self.f.stats.add(prefill_rows=rows)
            return (self.logits.clone(), self.k[:, :rows].clone(),
                    self.v[:, :rows].clone())


class _Backend:
    """The decode state both cache layouts share: logits [M, V], the
    staged token and active mask, the sampling state and the [chunk, M]
    token block, plus the graphs that update them."""

    def __init__(self, filt: "LlmFilter", m: int, max_len: int):
        dev = filt.device
        self.f = filt
        self.m = m
        self.max_len = max_len
        self.logits = torch.zeros(m, filt._cfg.vocab, dtype=torch.float32,
                                  device=dev)
        self.tok = torch.zeros(m, dtype=torch.long, device=dev)
        self.active = torch.zeros(m, dtype=torch.bool, device=dev)
        self.rng = {"seed": torch.zeros(m, dtype=torch.long, device=dev),
                    "counter": torch.zeros(m, dtype=torch.long, device=dev)}
        self.toks = torch.zeros(filt._chunk, m, dtype=torch.long, device=dev)
        # a tail chunk's tokens, one row a replay of the one-step graph
        self.tail = torch.zeros(filt._chunk, m, dtype=torch.long, device=dev)
        self.index: torch.Tensor = None
        self._graphs: Dict[Any, torch.cuda.CUDAGraph] = {}

    @torch.no_grad()
    def seat(self, slot: int, plen: int, logits: torch.Tensor,
             seed: int, drawn: int = 0) -> None:
        """Seat a stream: its position, first logits, and sampling seed
        with ``drawn`` draws already taken (a re-adopted stream's emitted
        tokens), so it continues the straight run's draws."""
        self.index[slot] = plen
        self.logits[slot] = logits[0]
        self.rng["seed"][slot] = seed
        self.rng["counter"][slot] = drawn

    @torch.no_grad()
    def sample(self, temperature: float) -> torch.Tensor:
        """One eager sampling step over the current logits; every lane's
        counter advances, as in the chunk graph (a lane's counter counts
        its stream's draws while it is seated)."""
        top_k, top_p = self.f._sampling()
        tok = tfm.sample_logits(self.logits, temperature, top_k, top_p,
                                self.rng)
        if temperature > 0:
            self.rng["counter"].add_(1)
        return tok

    def step(self, tok: torch.Tensor, active_np: np.ndarray) -> None:
        self._stage(active_np)
        self.tok.copy_(tok)
        self.f._run(self._graphs, "step", self._step)

    @torch.no_grad()
    def chunk(self, k: int, temperature: float,
              active_np: np.ndarray) -> torch.Tensor:
        """``k`` sample+decode rounds; returns the [k, M] token block (a
        view of a static block the next chunk overwrites). A full chunk
        replays the chunk graph; a shorter one (the tail of the deepest
        stream's budget, or of its cache) replays the one-step chunk
        graph k times, each token row copied out on the device, so a
        filter captures two chunk graphs, not one per tail length: each
        capture of a many-step graph costs seconds."""
        self._stage(active_np)
        n = self.toks.shape[0]
        if k == n:
            self.f._run(self._graphs, "chunk",
                        lambda: self._chunk(n, temperature))
            return self.toks
        for j in range(k):
            self.f._run(self._graphs, "chunk1",
                        lambda: self._chunk(1, temperature))
            self.tail[j].copy_(self.toks[0])
        return self.tail[:k]

    def _stage(self, active_np: np.ndarray) -> None:
        _stage(self.active, active_np)

    def free(self, slot: int) -> None:
        pass

    def admit_handoff(self, slot: int, flat: np.ndarray, kv: Dict,
                      budget: int) -> torch.Tensor:
        raise ValueError("llm: the contiguous cache cannot adopt a KV "
                         "handoff; decode replicas need custom=paged:true")


class _ContigBackend(_Backend):
    """Per-slot contiguous cache lanes (decode_step_multi): every slot
    reserves a worst-case [max_len] lane."""

    def __init__(self, filt: "LlmFilter", m: int, max_len: int):
        super().__init__(filt, m, max_len)
        self.cache = tfm.init_cache_multi(filt._cfg, m, max_len, filt.device)
        self.index = self.cache["index"]

    @torch.no_grad()
    def admit(self, slot: int, prompt: np.ndarray,
              budget: int) -> torch.Tensor:
        """Prefill ``prompt`` into lane ``slot``; returns its logits."""
        l1, k, v = self.f._prefill_prompt(prompt, self.max_len)
        # the whole lane is replaced: the last occupant cannot leak
        n = k.shape[1]
        self.cache["k"][:, slot, :n] = k
        self.cache["v"][:, slot, :n] = v
        self.cache["k"][:, slot, n:] = 0
        self.cache["v"][:, slot, n:] = 0
        return l1

    def _step(self) -> None:
        f = self.f
        logits, _ = tfm.decode_step_multi(f._params, self.cache, self.tok,
                                          self.active, f._cfg)
        self.logits.copy_(logits)

    def _chunk(self, k: int, temperature: float) -> None:
        f = self.f
        top_k, top_p = f._sampling()
        toks, logits, _, _ = tfm.decode_chunk_multi(
            f._params, self.cache, self.logits, self.rng, self.active,
            f._cfg, steps=k, temperature=temperature, top_k=top_k,
            top_p=top_p)
        self.toks[:k].copy_(toks)
        self.logits.copy_(logits)


class _PagedBackend(_Backend):
    """Block-pool cache (decode_step_paged): slots address KV through
    per-stream block tables over a shared arena, so occupancy is
    token-budgeted — admission asks for exactly
    ceil(min(plen + budget, max_len) / block_size) blocks — and
    block-aligned prompt prefixes are shared through the
    content-addressed cache (filters/kvpool.py)."""

    def __init__(self, filt: "LlmFilter", m: int, max_len: int):
        super().__init__(filt, m, max_len)
        self.bs = filt._block_size
        self.w = -(-max_len // self.bs)
        self.mgr = filt._pool_mgr
        self.discard = self.mgr.n_blocks
        self.pool = tfm.init_kv_pool(filt._cfg, self.mgr.n_blocks, self.bs,
                                     filt.device)
        self.table_np = np.full((m, self.w), self.discard, np.int64)
        self.table = torch.from_numpy(self.table_np).to(filt.device)
        self._table_dirty = False
        self.index = torch.zeros(m, dtype=torch.long, device=filt.device)
        self.blocks: List[List[int]] = [[] for _ in range(m)]

    def _need(self, plen: int, budget: int) -> int:
        return self.f._need_blocks(plen, budget)

    def _insert_span(self, blocks: List[int], k: torch.Tensor,
                     v: torch.Tensor, valid: int) -> None:
        """Write k/v [L, n, H, Dh] (first ``valid`` rows real) into
        ``blocks``, whole blocks, zeros past ``valid``."""
        layers, _, heads, hd = k.shape
        spanf = len(blocks) * self.bs
        n = min(int(valid), spanf, k.shape[1])
        kb = k.new_zeros(layers, spanf, heads, hd)
        vb = v.new_zeros(layers, spanf, heads, hd)
        kb[:, :n] = k[:, :n]
        vb[:, :n] = v[:, :n]
        sh = (layers, len(blocks), self.bs, heads, hd)
        tfm.pool_insert(self.pool, kb.view(sh), vb.view(sh),
                        torch.tensor(blocks, dtype=torch.long,
                                     device=k.device))

    @torch.no_grad()
    def admit(self, slot: int, prompt: np.ndarray,
              budget: int) -> torch.Tensor:
        """Prefill ``prompt`` (over its cached prefix, if warm) into
        fresh blocks seated in slot ``slot``; returns its logits."""
        from .kvpool import chain_hashes

        f = self.f
        plen = int(prompt.size)
        need = self._need(plen, budget)
        hashes = chain_hashes(prompt, self.bs)     # full blocks only
        # adoption never covers the whole prompt: at least one suffix
        # token recomputes (the logits come from it), and the first
        # decode-written block stays private, so shared blocks are
        # read-only by construction
        cover_cap = (plen - 1) // self.bs
        cov = self.mgr.lookup(hashes[:cover_cap]) if f._prefix_cache \
            else []
        fresh = self.mgr.alloc(need - len(cov))
        if fresh is None:
            if cov:
                self.mgr.release(cov)
            raise _PoolFull(f"need {need - len(cov)} blocks")
        allb = list(cov) + list(fresh)
        p0 = len(cov) * self.bs
        try:
            if cov:
                pk, pv = tfm.pool_gather(
                    self.pool, torch.tensor(cov, dtype=torch.long,
                                            device=f.device))
                l1, sk, sv = f._prefill(self.max_len)(prompt[p0:],
                                                      (pk, pv), p0)
                f.stats.add(prefill_dispatches=1, prefill_cached_tokens=p0,
                            prefill_computed_tokens=plen - p0)
                self._insert_span(fresh, sk, sv, plen - p0)
            else:
                l1, k, v = f._prefill_prompt(prompt, self.max_len)
                self._insert_span(allb, k, v, plen)
            if f._prefix_cache and hashes:
                self.mgr.commit(hashes, allb[:len(hashes)])
            self._seat(slot, allb, need)
        except BaseException:
            # admission failed after taking refs: hand every block back
            # (after a commit, release drops only the stream's refs)
            self.mgr.release(allb)
            raise
        return l1

    @torch.no_grad()
    def admit_handoff(self, slot: int, flat: np.ndarray, kv: Dict,
                      budget: int) -> torch.Tensor:
        """Fold a shipped K/V prefix (an ``edge/kv.py`` handoff dict) into
        fresh blocks seated in slot ``slot``; returns the stream's first
        logits. ``flat`` may extend the shipped prompt with tokens a
        replica emitted before a crash (snapshot re-adoption): that
        suffix is regrown by one ``prefill_with_past`` over the shipped
        prefix, so a resume costs the suffix, not the prompt."""
        f = self.f
        cfg = f._cfg
        plen = int(flat.size)
        t_ship = int(np.asarray(kv["prompt"]).size)
        if len(kv["k"].shape) != 4 or kv["k"].shape[1] < t_ship:
            raise ValueError(
                f"llm: malformed KV handoff {tuple(kv['k'].shape)}")
        k = _on_device(kv["k"], f.device, cfg.dtype)[:, :t_ship]
        v = _on_device(kv["v"], f.device, cfg.dtype)[:, :t_ship]
        f.stats.add(kv_shipped_tokens=t_ship)
        if plen > t_ship:
            l1, sk, sv = f._prefill(self.max_len)(flat[t_ship:], (k, v),
                                                  t_ship)
            f.stats.add(prefill_dispatches=1,
                        prefill_computed_tokens=plen - t_ship)
            k = torch.cat([k, sk[:, :plen - t_ship]], dim=1)
            v = torch.cat([v, sv[:, :plen - t_ship]], dim=1)
        else:
            l1 = _on_device(kv["logits"], f.device,
                            torch.float32).reshape(1, -1)
        need = self._need(plen, budget)
        fresh = self.mgr.alloc(need)
        if fresh is None:
            raise _PoolFull(f"need {need} blocks")
        try:
            self._insert_span(fresh, k, v, plen)
            if f._prefix_cache:
                from .kvpool import chain_hashes
                hashes = chain_hashes(np.asarray(kv["prompt"], np.int32),
                                      self.bs)
                usable = min(len(hashes), need)
                if usable:
                    self.mgr.commit(hashes[:usable], fresh[:usable])
            self._seat(slot, list(fresh), need)
        except BaseException:
            # a failed fold must not strand the blocks: the sender counts
            # only kv_handoff_errors, so a leaked ref would shrink the
            # pool for good
            self.mgr.release(list(fresh))
            raise
        return l1

    def _seat(self, slot: int, allb: List[int], need: int) -> None:
        self.table_np[slot, :need] = allb
        self.table_np[slot, need:] = self.discard
        self._table_dirty = True
        self.blocks[slot] = allb

    def _stage(self, active_np: np.ndarray) -> None:
        super()._stage(active_np)
        if self._table_dirty:
            _stage(self.table, self.table_np)
            self._table_dirty = False

    def _step(self) -> None:
        f = self.f
        logits, _, _ = tfm.decode_step_paged(
            f._params, self.pool, self.table, self.index, self.tok,
            self.active, f._cfg, max_len=self.max_len)
        self.logits.copy_(logits)

    def _chunk(self, k: int, temperature: float) -> None:
        f = self.f
        top_k, top_p = f._sampling()
        toks, logits, _, _, _ = tfm.decode_chunk_paged(
            f._params, self.pool, self.table, self.index, self.logits,
            self.rng, self.active, f._cfg, steps=k, max_len=self.max_len,
            temperature=temperature, top_k=top_k, top_p=top_p)
        self.toks[:k].copy_(toks)
        self.logits.copy_(logits)

    def free(self, slot: int) -> None:
        if self.blocks[slot]:
            self.mgr.release(self.blocks[slot])
            self.blocks[slot] = []


@register_filter
class LlmFilter(FilterFramework):
    NAME = "llm"
    EXTENSIONS = (".gguf",)  # reference auto-detect parity (llamacpp slot)
    # the prompt is read on the host (its length, the prefix digests)
    HOST_INPUTS = True

    def __init__(self):
        self._params: Optional[tfm.GPT] = None
        self._cfg: Optional[tfm.GPTConfig] = None
        self._opts: Dict[str, str] = {}
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # continuous-batching scheduler state (n_parallel > 1)
        self._pending: List[tuple] = []
        self._cond = threading.Condition()
        self._sched: Optional[threading.Thread] = None
        # the live slot table (published by _sched_body; stream
        # bookkeeping mutated under _cond) and the streams recovered from
        # a snapshot, adopted when a matching prompt arrives
        self._streams: Optional[List[Optional[Dict[str, Any]]]] = None
        self._recovered: Optional[Dict[str, Any]] = None
        # the prefill/decode split (role, the KV link's two ends)
        self._role = "both"
        self._kv_rx = None
        self._kv_tx = None
        self._paged = False
        self._backend: Optional[_Backend] = None
        self._pool_mgr = None
        # the single-stream path's decode state, one per max_len
        self._single: Dict[int, _ContigBackend] = {}
        self._single_lock = threading.Lock()
        # the prefill passes, one per max_len
        self._prefills: Dict[int, _Prefill] = {}
        self._prefill_lock = threading.Lock()
        self._graph_pool: Optional[GraphPool] = None
        self._own_pool = False
        self.device: Optional[torch.device] = None
        # graphs captured (the prefill pass, the step, the chunk loop)
        self.compile_count = 0

    def open(self, props: FilterProperties) -> None:
        model = props.model_files[0] if props.model_files else ""
        opts = _parse_custom(props.custom_properties)
        self.device = device_for(props.accelerators)
        full_f32_numerics()
        if model.startswith("zoo://"):
            parsed = urllib.parse.urlparse(model)
            kwargs = {k: v[0] for k, v in
                      urllib.parse.parse_qs(parsed.query).items()}
            name = parsed.netloc or parsed.path.lstrip("/")
            if name != "gpt":
                raise ValueError(f"llm filter expects zoo://gpt, got {name}")
            self._cfg = tfm.GPTConfig(
                vocab=int(kwargs.get("vocab", "32000")),
                d_model=int(kwargs.get("d_model", "512")),
                n_heads=int(kwargs.get("n_heads", "8")),
                n_layers=int(kwargs.get("n_layers", "6")))
            gen = torch.Generator(device=self.device).manual_seed(
                int(kwargs.get("seed", "0")))
            self._params = tfm.init_params(self._cfg, gen)
            if "params_dir" in kwargs:
                # trained weights (e.g. saved by tensor_trainer): the
                # seeded init above is the template they load into
                from ..trainers.checkpoint import restore_params
                restore_params(kwargs["params_dir"], self._params)
        elif model.endswith(".py"):
            ns: Dict[str, Any] = {}
            with open(model) as f:
                exec(compile(f.read(), model, "exec"), ns)  # noqa: S102 — user script
            params, self._cfg = ns["get_lm"]()
            if not isinstance(params, tfm.GPT):
                from ..models.convert import gpt_params_from_jax
                module = tfm.GPT(self._cfg)
                module.load_state_dict(gpt_params_from_jax(params))
                params = module
            self._params = params.to(self.device)
        elif model.endswith(".gguf"):
            raise NotImplementedError(
                "llm: .gguf weight loading is not implemented; export "
                "the weights to a get_lm() python module instead")
        else:
            raise ValueError(f"llm filter cannot load model {model!r}")
        self._opts = opts
        self._own_pool = props.graph_pool is None
        self._graph_pool = GraphPool() if self._own_pool \
            else props.graph_pool
        self._n_parallel = int(opts.get("n_parallel", "1"))
        # chunk:K folds K sample+decode rounds into one graph replay and
        # one token fetch; streams are token-identical to chunk:1, the
        # cost is admission latency (a new prompt waits for the chunk)
        self._chunk = max(1, int(opts.get("chunk", "1")))
        self._sampling_cache = None
        self._role = opts.get("role", "both")
        if self._role not in ("both", "prefill", "decode"):
            raise ValueError(f"llm: unknown role {self._role!r}; "
                             "expected prefill|decode|both")
        # a decode replica folds shipped K/V into the block pool
        self._paged = (opts.get("paged", "false").lower() in _TRUE
                       or self._role == "decode")
        self._kv_precision = opts.get("kv_precision", "none")
        self._prefix_cache = opts.get("prefix_cache",
                                      "true").lower() in _TRUE
        self._block_size = max(1, int(opts.get("block_size", "16")))
        self._batch_max_len = int(opts.get("max_len",
                                           str(DEFAULT_BATCH_MAX_LEN)))
        self._backend = None
        self._pool_mgr = None
        self._single.clear()
        self._prefills.clear()
        if self._paged:
            if self._n_parallel < 2:
                raise ValueError(
                    "llm: paged/decode mode requires n_parallel>1 — the "
                    "block pool backs the continuous-batching scheduler")
            from .kvpool import KVBlockPool
            w = -(-self._batch_max_len // self._block_size)
            # the default budget is the contiguous layout's worst case
            n_blocks = int(opts.get("pool_blocks", str(self._n_parallel * w)))
            self._pool_mgr = KVBlockPool(n_blocks, self._block_size,
                                         name="llm")
        with self._cond:
            # prompts queued before a close() belong to the last session
            self._pending.clear()
            self._streams = None
        self._stop.clear()
        # prefill passes, the prompt tokens they computed or found in
        # the prefix cache, and the rows they ran (the computed tokens
        # padded to their bucket); decode_steps counts the weight-reading
        # steps run (a chunk of k counts k), decode_dispatches the
        # decode rounds (one a step, or one a chunk); the kv_ counters
        # are the phase split's: prompt tokens that arrived as shipped
        # K/V, streams shipped and adopted, ships that failed or were
        # refused, and the host ns from each prefill pass's return to its
        # KV_ACK (the copy off the card, the wire, the receiver's queue)
        self.stats = Counters(prefill_dispatches=0, decode_dispatches=0,
                              decode_steps=0, prefill_computed_tokens=0,
                              prefill_cached_tokens=0, prefill_rows=0,
                              kv_shipped_tokens=0, kv_handoffs_in=0,
                              kv_handoffs_out=0, kv_handoff_errors=0,
                              kv_handoff_ns=0)
        if self._role == "decode" or "handoff_port" in opts:
            from ..edge.kv import KvReceiver
            self._kv_rx = KvReceiver(
                "0.0.0.0", int(opts.get("handoff_port", "0")),
                self._on_kv_handoff, precision=self._kv_precision,
                name="llm-kv-rx", stats=self.stats).start()
        logger.info("llm filter opened %s on %s", model, self.device)

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._kv_rx is not None:
            self._kv_rx.stop()
            self._kv_rx = None
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        if self._sched is not None:
            # the scheduler stops at a round's end, after the round's
            # tokens are dispatched and booked: _streams stays readable
            # for snapshot_state, its emitted lists what was delivered
            self._sched.join(timeout=5.0)
            self._sched = None
        if self._kv_tx is not None:
            self._kv_tx.close()
            self._kv_tx = None
        with self._single_lock:
            self._single.clear()
        self._prefills.clear()
        self._backend = None
        self._params = None
        if self._own_pool and self._graph_pool is not None:
            self._graph_pool.release()
        self._graph_pool = None

    @property
    def handoff_port(self) -> Optional[int]:
        """The bound KV_XFER port of a decode-role filter (handoff_port:0
        resolved to the port the OS picked)."""
        return self._kv_rx.bound_port if self._kv_rx is not None else None

    def get_model_info(self):
        # prompt length is per-buffer (dynamic): input derives from caps
        return None, TensorsInfo.make("int32", "1")

    def set_input_info(self, info: TensorsInfo) -> Optional[TensorsInfo]:
        return TensorsInfo.make("int32", "1")

    # -- generation -------------------------------------------------------
    def _check_prompt(self, prompt: np.ndarray, max_len: int) -> None:
        """Fail on the host before any launch: an empty or oversized
        prompt, or a token id outside the vocabulary (an out-of-range
        embedding read on the card is a device-side assert)."""
        if prompt.size == 0:
            raise ValueError("llm: empty prompt")
        if prompt.size > max_len:
            raise ValueError(
                f"llm: prompt length {prompt.size} exceeds max_len "
                f"{max_len}; raise custom=max_len:N")
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self._cfg.vocab:
            raise ValueError(
                f"llm: token id {lo if lo < 0 else hi} is outside the "
                f"vocabulary [0, {self._cfg.vocab})")

    def _run(self, graphs: Dict[Any, Any], key: Any, fn) -> None:
        """``fn`` eagerly on the CPU; on the card its graph in ``graphs``:
        captured at the first call (which runs it eagerly once), replayed
        after; ``compile_count`` counts the captures."""
        if self.device.type != "cuda":
            with torch.no_grad():
                fn()
            return
        graph = graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        graphs[key] = capture_in_place(
            fn, self.device, self._graph_pool.handle_for(self.device))
        self.compile_count += 1

    def _prefill(self, max_len: int) -> "_Prefill":
        with self._prefill_lock:
            pre = self._prefills.get(max_len)
            if pre is None:
                pre = self._prefills[max_len] = _Prefill(self, max_len)
            return pre

    def _prefill_prompt(self, prompt: np.ndarray, max_len: int):
        """One prefill pass of the prompt, padded to its bucket, over no
        past: (logits [1, V], K, V [L, bucket, H, Dh]), rows past the
        prompt garbage the decode loop overwrites before its mask reaches
        them."""
        out = self._prefill(max_len)(prompt)
        self.stats.add(prefill_dispatches=1,
                       prefill_computed_tokens=int(prompt.size))
        return out

    def _sampling(self):
        """(top_k, top_p), parsed once (llamacpp's sampler knobs)."""
        if self._sampling_cache is None:
            self._sampling_cache = (int(self._opts.get("top_k", "0")),
                                    float(self._opts.get("top_p", "1.0")))
        return self._sampling_cache

    def _generate(self, prompt: np.ndarray, emit) -> None:
        prompt = np.asarray(prompt).reshape(-1)
        max_tokens = int(self._opts.get("max_tokens", "16"))
        temperature = float(self._opts.get("temperature", "0"))
        # the default max_len derives from the prompt's power-of-two
        # bucket, so the decode state (and its graphs) is bucket-stable
        bucket = 8
        while bucket < max(prompt.size, 1):
            bucket *= 2
        max_len = int(self._opts.get("max_len", str(bucket + max_tokens)))
        self._check_prompt(prompt, max_len)
        on = np.ones(1, bool)
        with self._single_lock:
            be = self._single.get(max_len)
            if be is None:
                be = self._single[max_len] = _ContigBackend(self, 1, max_len)
            be.seat(0, int(prompt.size), be.admit(0, prompt, max_tokens),
                    int(self._opts.get("seed", "0")))
            pos = int(prompt.size)
            if self._chunk > 1:
                self._generate_chunked(be, pos, max_tokens, max_len,
                                       temperature, emit)
                return
            for i in range(max_tokens):
                if self._stop.is_set():
                    return
                tok = be.sample(temperature)
                emit(_host(tok).astype(np.int32))
                if i + 1 >= max_tokens or pos >= max_len:
                    return  # nothing left to decode: skip the last step
                be.step(tok, on)
                self.stats.add(decode_dispatches=1, decode_steps=1)
                pos += 1

    def _generate_chunked(self, be: _Backend, pos: int, max_tokens: int,
                          max_len: int, temperature: float, emit) -> None:
        """Single-stream chunked decode: [chunk] tokens a replay and a
        fetch; the per-token loop's tokens and capacity cutoff."""
        on = np.ones(1, bool)
        remaining = max_tokens
        while remaining > 0 and not self._stop.is_set():
            # each round samples then decodes; a decode writes at the
            # stream's position, legal while it is <= max_len - 1
            k = min(self._chunk, remaining, max_len - pos)
            if k <= 0:
                # cache full: the per-token loop still emits one final
                # sampled token before stopping
                emit(_host(be.sample(temperature)).astype(np.int32))
                return
            toks = _host(be.chunk(k, temperature, on))   # one fetch
            self.stats.add(decode_dispatches=1, decode_steps=k)
            for j in range(k):
                emit(toks[j].astype(np.int32))
            pos += k
            remaining -= k

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        """Sync path: the whole generation as one int32 tensor."""
        tokens: List[np.ndarray] = []
        self._generate(np.asarray(inputs[0]), tokens.append)
        return [np.concatenate(tokens) if tokens
                else np.zeros((0,), np.int32)]

    def invoke_async(self, inputs: Sequence[Any], ctx: Any = None) -> None:
        """1-in/N-out: one output frame per generated token, each
        dispatched with this invoke's ``ctx``. A prefill-role filter
        dispatches nothing: it ships the prompt's K/V to its decode home,
        and the decode replica emits the tokens."""
        prompt = np.asarray(inputs[0])
        if self._role == "prefill":
            flat = prompt.reshape(-1).astype(np.int32)
            self._check_prompt(flat, self._batch_max_len)
            self._spawn(self._prefill_and_ship, (flat, ctx),
                        "llm-prefill-ship")
            return
        if self._n_parallel > 1:
            # validate on the caller's thread: an oversized prompt is a
            # visible invoke error, not a silent scheduler drop
            flat = prompt.reshape(-1)
            self._check_prompt(flat, self._batch_max_len)
            with self._cond:
                rem, drawn = None, 0
                if self._recovered is not None:
                    # a re-submitted prompt that matches a snapshotted
                    # stream continues it: the emitted tokens (delivered
                    # before the crash) join the prefill and only the
                    # rest of the budget is generated
                    rem, flat, drawn = self._adopt_recovered_locked(flat)
                self._enqueue_stream_locked((flat, ctx, rem, None, drawn))
            return

        def run():
            try:
                self._generate(
                    prompt, lambda tok: self._dispatch([tok], ctx))
            except Exception:  # noqa: BLE001
                logger.exception("llm generation failed")

        self._spawn(run, (), "llm-generate")

    def _spawn(self, target, args: tuple, name: str) -> None:
        """One invoke's worker thread; close() joins the live ones."""
        self._threads = [t for t in self._threads if t.is_alive()]
        t = threading.Thread(target=target, args=args, name=name,
                             daemon=True)
        self._threads.append(t)
        t.start()

    def _enqueue_stream_locked(self, entry: tuple) -> None:
        """Queue a stream for the scheduler (caller holds _cond); one
        scheduler, started under the lock."""
        self._pending.append(entry)
        self._cond.notify_all()
        if self._sched is None or not self._sched.is_alive():
            self._sched = threading.Thread(
                target=self._sched_loop, name="llm-sched", daemon=True)
            self._sched.start()

    # -- prefill/decode split (role, the KV handoff) ----------------------
    def _handoff_sender(self):
        with self._cond:
            if self._kv_tx is None:
                target = self._opts.get("handoff", "")
                if not target:
                    raise ValueError(
                        "llm: role:prefill requires custom=handoff:host:port")
                host, _, port = target.rpartition(":")
                from ..edge.kv import KvSender
                self._kv_tx = KvSender(host or "127.0.0.1", int(port),
                                       precision=self._kv_precision,
                                       stats=self.stats)
            return self._kv_tx

    def _prefill_and_ship(self, flat: np.ndarray, ctx: Any) -> None:
        """Prefill-role path: one prompt pass, then the prompt's K/V and
        last logits to the decode home over KV_XFER, off the card in one
        copy batch. The trace context (minted here when the invoke
        carried none) rides the wire, so prefill -> handoff -> decode is
        one tree."""
        from ..checkpoint.state import token_sha
        from ..obs import spans as _spans
        try:
            max_tokens = int(self._opts.get("max_tokens", "16"))
            t0 = time.time_ns()
            tctx = _ctx_of(ctx)
            if tctx is None and _spans.ENABLED:
                from ..obs import context as _obs_ctx
                tctx = _obs_ctx.TraceContext(_obs_ctx.next_id(), 0, t0)
            l1, k, v = self._prefill_prompt(flat, self._batch_max_len)
            t_pass = time.perf_counter_ns()
            t = int(flat.size)
            k_h, v_h, l_h = fetch_host([k[:, :t], v[:, :t], l1[0]])
            if tctx is not None:
                _spans.record_span("llm-prefill", "llm", t0,
                                   max(0, time.time_ns() - t0), tctx)
            ack = self._handoff_sender().send(
                token_sha(flat), flat, k_h, v_h, l_h, remaining=max_tokens,
                seed=int(self._opts.get("seed", "0")), ctx=tctx)
            self.stats.add(kv_handoffs_out=1,
                           kv_handoff_ns=time.perf_counter_ns() - t_pass)
            if not ack.get("adopted"):
                self.stats.inc("kv_handoff_errors")
                logger.error("llm: decode replica refused stream %s",
                             ack.get("sid"))
        except Exception:  # noqa: BLE001 — a failed ship is counted and logged, not fatal
            self.stats.inc("kv_handoff_errors")
            logger.exception("llm: kv handoff failed")

    def _need_blocks(self, plen: int, budget: int) -> int:
        """Blocks a paged stream of ``plen`` prompt tokens and ``budget``
        new ones takes: ceil(min(plen + budget, max_len) / block_size),
        at least the prompt's."""
        span = max(plen, min(plen + int(budget), self._batch_max_len))
        return -(-span // self._block_size)

    def _on_kv_handoff(self, d: Dict) -> bool:
        """KvReceiver callback (on the link's thread): queue a shipped
        stream for paged admission. The return is the KV_ACK's
        ``adopted``: False tells the prefill side to try another decode
        home. A filter without the paged pool, or a stream that needs
        more blocks than the whole pool holds, is refused here; the JAX
        filter acks either and its scheduler drops the stream later, so
        the prefill side counted it adopted."""
        if self._stop.is_set() or self._params is None:
            return False
        if not self._paged:
            logger.error("llm: KV handoff %s refused: only a paged filter "
                         "(role:decode or paged:true) adopts one",
                         d.get("sid"))
            return False
        flat = np.asarray(d["prompt"], np.int32).reshape(-1)
        try:
            self._check_prompt(flat, self._batch_max_len)
        except ValueError:
            logger.exception("llm: rejected KV handoff %s", d.get("sid"))
            return False
        with self._cond:
            rem = int(d.get("remaining", 0)) or None
            drawn = 0
            if self._recovered is not None:
                # a re-shipped conversation adopts its snapshot: the
                # emitted tokens join the context, the rest is generated
                rem2, flat, drawn = self._adopt_recovered_locked(flat)
                if rem2 is not None:
                    rem = rem2
            budget = int(self._opts.get("max_tokens", "16")) \
                if rem is None else rem
            if self._need_blocks(flat.size, budget) > \
                    self._pool_mgr.n_blocks:
                logger.error(
                    "llm: KV handoff %s of %d tokens needs more blocks "
                    "than pool_blocks=%d holds; refused", d.get("sid"),
                    int(flat.size), self._pool_mgr.n_blocks)
                return False
            self._enqueue_stream_locked((flat, d.get("sid"), rem, d, drawn))
        self.stats.inc("kv_handoffs_in")
        return True

    # -- checkpoint/restore (checkpoint/) ----------------------------------
    def snapshot_state(self, snap_dir) -> Optional[Dict[str, Any]]:
        """Continuous-batching state for a snapshot: per stream (queued
        or running) the prompt, the tokens already emitted and the
        remaining budget. The KV cache is not saved: adoption recomputes
        it with one prefill over prompt + emitted. Single-stream mode
        (``n_parallel:1``) keeps no scheduler state and snapshots
        nothing."""
        with self._cond:
            pend = [{"prompt": np.asarray(e[0], np.int32).tolist(),
                     "emitted": [],
                     "remaining": e[2] if len(e) > 2 else None}
                    for e in self._pending]
            act = [{"prompt": s["prompt"].tolist(),
                    "emitted": list(s["emitted"]),
                    "remaining": int(s["remaining"])}
                   for s in (self._streams or [])
                   if s is not None and s["remaining"] > 0]
        if not pend and not act:
            return None
        return {"streams": act + pend}

    def restore_state(self, state, snap_dir) -> None:
        """Stash recovered streams; a re-submitted prompt or a re-shipped
        handoff that matches one adopts it (invoke_async,
        _on_kv_handoff)."""
        with self._cond:
            self._recovered = state

    def _adopt_recovered_locked(self, flat: np.ndarray):
        """Match an incoming prompt against the recovered streams (caller
        holds _cond) by content digest (``token_sha``, the digest that
        names handoffs), each entry's computed once. On a hit the stream
        continues: prompt + emitted become the prefill context and only
        the remaining budget is generated. Returns (remaining override,
        prompt to queue, draws already taken)."""
        from ..checkpoint.state import token_sha

        entries = self._recovered.get("streams") or []
        sha = token_sha(flat)
        for i, ent in enumerate(entries):
            esha = ent.get("_sha")
            if esha is None:
                esha = ent["_sha"] = token_sha(
                    np.asarray(ent.get("prompt") or [], np.int32))
            if esha == sha:
                entries.pop(i)
                if not entries:
                    self._recovered = None
                emitted = np.asarray(ent.get("emitted") or [], np.int32)
                if emitted.size:
                    flat = np.concatenate([flat.astype(np.int32), emitted])
                return ent.get("remaining"), flat, int(emitted.size)
        return None, flat, 0

    # -- continuous-batching scheduler (n_parallel > 1) --------------------
    def _finish_span(self, s: Dict[str, Any]) -> None:
        """A stream finished: close its llm-decode span, the terminal
        node of its trace tree on this replica."""
        tctx = s.get("tctx")
        if tctx is None:
            return
        from ..obs import spans as _spans
        _spans.record_span("llm-decode", "llm", s["t0"],
                           max(0, time.time_ns() - s["t0"]), tctx)

    def _sched_loop(self) -> None:
        """Decode M streams per step: pending prompts are prefilled into
        free slots, every active slot advances one token per shared
        step, and finished slots free up for waiting prompts."""
        try:
            self._sched_body()
        except Exception:  # noqa: BLE001 — daemon thread: log, don't die silent
            logger.exception("llm scheduler failed; in-flight streams lost")

    def _sched_body(self) -> None:
        m = self._n_parallel
        max_tokens = int(self._opts.get("max_tokens", "16"))
        max_len = self._batch_max_len
        temperature = float(self._opts.get("temperature", "0"))
        seed = int(self._opts.get("seed", "0"))
        # one loop for both layouts: admission, sampling and bookkeeping
        # are shared, only the cache math differs
        backend = (_PagedBackend(self, m, max_len) if self._paged
                   else _ContigBackend(self, m, max_len))
        self._backend = backend
        streams: List[Optional[Dict[str, Any]]] = [None] * m
        with self._cond:
            self._streams = streams  # published for snapshot_state
        while not self._stop.is_set():
            with self._cond:
                while all(s is None for s in streams) and not self._pending \
                        and not self._stop.is_set():
                    self._cond.wait(0.1)
                if self._stop.is_set():
                    return
                admit = []
                for slot in range(m):
                    if streams[slot] is None and self._pending:
                        admit.append((slot, self._pending.pop(0)))
            requeue = []
            for slot, entry in admit:
                prompt, ctx, rem, kv, drawn = entry
                budget = max_tokens if rem is None else int(rem)
                t_admit = time.time_ns()
                try:
                    if kv is not None:
                        logits = backend.admit_handoff(slot, prompt, kv,
                                                       budget)
                    else:
                        self._check_prompt(prompt, max_len)
                        logits = backend.admit(slot, prompt, budget)
                except _PoolFull:
                    # not enough KV blocks now: running streams release
                    # blocks as they finish
                    requeue.append(entry)
                    continue
                except Exception:  # noqa: BLE001 — drop THIS prompt only
                    logger.exception("llm: prompt rejected at admission")
                    continue
                tctx = kv.get("ctx") if kv is not None else _ctx_of(ctx)
                if tctx is not None and kv is None:
                    from ..obs import spans as _spans
                    _spans.record_span("llm-prefill", "llm", t_admit,
                                       max(0, time.time_ns() - t_admit),
                                       tctx)
                # per-stream seed: the draws match the n_parallel=1 path
                # whatever else is in flight; a handoff stream samples
                # with the seed its prefill replica shipped (the split
                # emits the monolithic stream), a re-adopted one from
                # the draws it already took
                backend.seat(slot, int(prompt.size), logits,
                             int(kv["seed"]) if kv is not None else seed,
                             drawn)
                streams[slot] = {"ctx": ctx, "remaining": budget,
                                 "pos": int(prompt.size),
                                 "prompt": np.asarray(prompt,
                                                      np.int32).copy(),
                                 "emitted": [], "tctx": tctx,
                                 "t0": t_admit}
            if requeue:
                with self._cond:
                    if all(s is None for s in streams):
                        # nothing runs, so nothing will free blocks: the
                        # head request exceeds the whole pool
                        head = requeue.pop(0)
                        logger.error(
                            "llm: stream of %d tokens needs more KV "
                            "blocks than pool_blocks=%d holds; dropped",
                            int(np.asarray(head[0]).size),
                            self._pool_mgr.n_blocks)
                    self._pending[:0] = requeue
            active_np = np.array([s is not None for s in streams])
            if not active_np.any():
                continue
            if self._chunk > 1:
                self._sched_chunk(streams, active_np, backend, max_len,
                                  temperature)
                continue
            tok = backend.sample(temperature)
            tok_host = _host(tok).astype(np.int32)   # one fetch, all slots
            for slot, s in enumerate(streams):
                if s is None:
                    continue
                self._dispatch([tok_host[slot:slot + 1]], s["ctx"])
                with self._cond:
                    # booked under _cond: a snapshot reads (prompt,
                    # emitted, remaining) coherently
                    s["emitted"].append(int(tok_host[slot]))
                    s["remaining"] -= 1
                    s["pos"] += 1
                # pos is one past the next decode's write position, so
                # the stream survives while pos <= max_len: the
                # single-stream loop's emit-then-check order
                if s["remaining"] <= 0 or s["pos"] > max_len:
                    streams[slot] = None
                    active_np[slot] = False   # no trailing write/advance
                    backend.free(slot)
                    self._finish_span(s)
            if active_np.any():
                backend.step(tok, active_np)
                self.stats.add(decode_dispatches=1, decode_steps=1)

    def _sched_chunk(self, streams, active_np, backend, max_len,
                     temperature) -> None:
        """One chunked round: K sample+decode steps in one replay, K
        tokens a stream in one fetch. K serves the deepest stream still
        running, so no stream emits past its budget; surplus lane tokens
        of streams that finish mid-chunk are discarded. The +1 is the
        capacity tail: the last token a lane emits at pos == max_len is
        sampled from the last legal decode's logits, and the decode after
        it is position-guarded in the step."""
        emits_left = [min(s["remaining"], max_len - s["pos"] + 1)
                      if s else 0 for s in streams]
        k = min(self._chunk, max(emits_left))
        toks = _host(backend.chunk(k, temperature, active_np))  # [k, M]
        self.stats.add(decode_dispatches=1, decode_steps=k)
        for slot, s in enumerate(streams):
            if s is None:
                continue
            for j in range(min(k, emits_left[slot])):
                self._dispatch([toks[j, slot:slot + 1].astype(np.int32)],
                               s["ctx"])
                with self._cond:
                    s["emitted"].append(int(toks[j, slot]))
                    s["remaining"] -= 1
                    s["pos"] += 1
            if s["remaining"] <= 0 or s["pos"] > max_len:
                streams[slot] = None
                backend.free(slot)
                self._finish_span(s)

