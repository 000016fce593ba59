"""Decoder-only transformer LM: the model of the generative line.

Port of ``nnstreamer_tpu/models/transformer.py`` (the model behind the
reference's llama.cpp / llama2.c slot, ref: ext/nnstreamer/tensor_filter/
tensor_filter_llamacpp.cc): RoPE positions, RMSNorm, SwiGLU MLP, causal
attention, a KV cache for one-token decode, a block-paged KV arena and
per-stream sampling. ``filters/llm.py`` runs it.

The parameters are a :class:`GPT` module with the JAX tree's names and
layouts (``embed`` ``[V, d]``, ``head`` ``[d, V]``, each layer's ``wq``
... ``w2`` as ``[in, out]``, so ``x @ w`` reads as in JAX); the model
functions are plain functions of it, as the JAX ones are of the tree.
:func:`..convert.gpt_params_from_jax` turns a JAX tree into its
``state_dict``.

The attention is computed as the JAX code computes it, in plain torch:
the score product in the model dtype, cast to f32 and scaled, masked to
-1e30, softmax in f32, the probabilities cast back before the PV product.
No SDPA: it rounds elsewhere, and the paged path must equal the
contiguous one bit for bit.

Where JAX threads the cache through ``jit`` as functional state, the
port writes it in place (the caller's cache, pool and index tensors are
updated and also returned, so the call shapes stay JAX's): the decode
state of the LLM filter lives in static tensors that captured CUDA
graphs update. JAX's index arithmetic clamps where torch would wrap or
assert, so the port clamps by hand:

* the last-position read of a prefill clamps ``true_len - 1`` into the
  prompt (JAX's ``dynamic_slice_in_dim``);
* a guarded lane of :func:`decode_step_multi` (inactive, or at
  ``max_len``) writes its old row back at its position clamped to
  ``max_len - 1`` — a no-op, as JAX's clamped ``dynamic_update_slice``;
* the paged arena has one block more than the allocator hands out:
  block ``NB`` is the discard block, where :func:`decode_step_paged`
  aims the writes JAX drops with ``mode="drop"`` (an out-of-range
  ``index_put_`` on CUDA is a device-side assert).

:func:`prefill_with_past` keeps each K/V row at its absolute position
(column ``j`` of the attended buffer is position ``j``, where JAX
concatenates past and suffix), so a row's attention reads the same
columns whichever call computed it: with fixed shapes, a prompt
prefilled over a cached prefix gives the bits of one prefilled whole
(the prefix cache's exactness on the card rests on it).

Sampling draws per-stream noise from a counter-based hash of (seed,
step, token) in integer tensor ops (:func:`uniform_noise`), where JAX
splits a ``PRNGKey`` per step: the tokens differ from JAX's, the
properties are JAX's — a stream's draws do not depend on the other
streams in flight, chunked equals per-token, and the noise is safe to
capture in a graph. The candidate set (``top_k``/``top_p`` formed on the
unscaled logits, before temperature) is JAX's.

:func:`loss_fn` is the next-token cross-entropy the trainer (a
``tensor_trainer`` model-config file) differentiates.

The mesh fields (``mesh``, ``data_axis``, ``seq_axis``, ``model_axis``,
``seq_scheme``) are the JAX config's. With a mesh, :func:`forward` and
:func:`loss_fn` called outside a mesh command run as one
(parallel/world.py): the token batch is split over ``data`` (as
parallel/sharding.py ``batch_sharding`` splits it), each rank takes its
block of the sequence when the ``seq`` axis is larger than 1 and
attends across the blocks with ring or Ulysses attention, and weights a
rule shards over ``model`` are DTensors on ``mesh["model"]``, so
DTensor inserts the tensor-parallel collectives; :func:`_constrain`
pins activations over ``model`` as the JAX code's
``with_sharding_constraint`` does. Inside a command (the sharded train
step, parallel/train.py) the same functions take this rank's rows with
the whole sequence and return this rank's block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..tensors.info import TensorsInfo
from .zoo import register_model


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 0          # 0 -> 4*d_model
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # distributed knobs (None = one device): a parallel/mesh.py mesh
    mesh: Any = None
    data_axis: Optional[str] = "data"
    seq_axis: Optional[str] = None     # set to e.g. "seq" for seq parallelism
    model_axis: Optional[str] = "model"
    # sequence-parallel attention scheme: "ring" (K/V rotated around the
    # ring, any head count) or "ulysses" (all-to-all head/seq exchange,
    # needs local heads % seq_axis_size == 0) — both exact
    seq_scheme: str = "ring"

    @property
    def ff(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class GPTBlock(nn.Module):
    """One layer's weights, named and laid out as the JAX tree's."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.ff, cfg.dtype
        for name, shape in (("ln1", (d,)), ("wq", (d, d)), ("wk", (d, d)),
                            ("wv", (d, d)), ("wo", (d, d)), ("ln2", (d,)),
                            ("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d))):
            setattr(self, name, _param(shape, dt, device))


class GPT(nn.Module):
    """The parameters of :class:`GPTConfig`'s model (uninitialised;
    :func:`init_params` draws them)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d, v, dt = cfg.d_model, cfg.vocab, cfg.dtype
        self.embed = _param((v, d), dt, device)
        self.head = _param((d, v), dt, device)
        self.ln_f = _param((d,), dt, device)
        self.layers = nn.ModuleList(GPTBlock(cfg, device)
                                    for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(cfg: GPTConfig, generator: torch.Generator) -> GPT:
    """Seeded random weights, drawn on ``generator``'s device: f32
    normals scaled as the JAX init scales them, rounded to ``cfg.dtype``;
    the norms' scales are ones. A generator on the card gives other
    numbers than one on the CPU for the same seed."""
    device = generator.device
    m = GPT(cfg, device)
    d, f, n = cfg.d_model, cfg.ff, cfg.n_layers

    def dense(p: torch.Tensor, scale: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=device,
                            dtype=torch.float32) * scale)

    dense(m.embed, d ** -0.5)
    dense(m.head, d ** -0.5)
    m.ln_f.fill_(1.0)
    for layer in m.layers:
        for name in ("wq", "wk", "wv"):
            dense(getattr(layer, name), d ** -0.5)
        dense(layer.wo, (2 * d * n) ** -0.5)
        dense(layer.w1, d ** -0.5)
        dense(layer.w3, d ** -0.5)
        dense(layer.w2, (2 * f * n) ** -0.5)
        layer.ln1.fill_(1.0)
        layer.ln2.fill_(1.0)
    return m


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_tables(positions: torch.Tensor, dh: int, theta: float):
    """(cos, sin) [..., S, 1, Dh/2] f32 of the rotary angles at
    ``positions`` [..., S]: one pair serves q and k of every layer."""
    half = torch.arange(0, dh // 2, dtype=torch.float32,
                        device=positions.device)
    freqs = torch.pow(theta, -half / (dh // 2))
    angles = positions[..., None].float() * freqs      # [..., S, Dh/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim. x: [..., S, H, Dh]."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], theta))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """q [B,S,H,Dh], k/v [B,K,H,Dh], mask broadcasting to [B,H,S,K]
    (True = attend) -> [B,S,H,Dh], with JAX's roundings."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (q.shape[-1] ** -0.5)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dense_attention(q, k, v, positions_q, positions_k):
    """q,k,v: [B,S,H,Dh]; causal by absolute position."""
    mask = positions_q[:, None, :, None] >= positions_k[:, None, None, :]
    return _attend(q, k, v, mask, q.dtype)


def _axis(cfg: GPTConfig, axis: Optional[str]) -> int:
    if cfg.mesh is None:
        return 1
    from ..parallel.mesh import axis_size
    return axis_size(cfg.mesh, axis)


def _constrain(x, cfg: GPTConfig, spec):
    """Activation sharding hint over the model axis (the only axis an
    activation is a DTensor on); a no-op off-mesh and on plain tensors."""
    if cfg.mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    want = Replicate()
    for d, axis in enumerate(spec):
        if axis is not None and axis == cfg.model_axis:
            want = Shard(d)
    if x.placements[0] != want:
        x = x.redistribute(x.device_mesh, [want])
    return x


def _attention(q, k, v, positions, cfg: GPTConfig):
    if cfg.seq_scheme not in ("ring", "ulysses"):
        # both schemes are exact, so a typo would be undetectable from
        # outputs — fail loudly instead of silently running ring
        raise ValueError(f"unknown seq_scheme {cfg.seq_scheme!r}; "
                         "expected 'ring' or 'ulysses'")
    if _axis(cfg, cfg.seq_axis) > 1:
        from functools import partial
        if cfg.seq_scheme == "ulysses":
            from ..parallel.ulysses import check_heads, ulysses_attention_local
            check_heads(cfg.n_heads, cfg.mesh, cfg.seq_axis, cfg.model_axis)
            body = ulysses_attention_local
        else:
            from ..parallel.ring import ring_attention_local
            body = ring_attention_local
        fn = partial(body, mesh=cfg.mesh, axis_name=cfg.seq_axis)
        from torch.distributed.tensor import DTensor
        if isinstance(q, DTensor):
            # heads sharded over model: the body runs on the local heads
            from torch.distributed.tensor import Shard
            from torch.distributed.tensor.experimental import local_map
            q, k, v = (_constrain(x, cfg, (None, None, cfg.model_axis))
                       for x in (q, k, v))
            pl = [Shard(2)]
            fn = local_map(fn, out_placements=pl, in_placements=(pl, pl, pl),
                           device_mesh=q.device_mesh)
        return fn(q, k, v)
    return _dense_attention(q, k, v, positions, positions)


def _seq_block(x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """This rank's block of the sequence (dim 1) when the seq axis is
    larger than 1."""
    n = _axis(cfg, cfg.seq_axis)
    if n == 1:
        return x
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} does not divide "
                         f"over the seq axis ({n})")
    t = x.shape[1] // n
    i = cfg.mesh.get_local_rank(cfg.seq_axis)
    return x[:, i * t:(i + 1) * t]


def _mlp(h: torch.Tensor, layer: GPTBlock) -> torch.Tensor:
    x = rmsnorm(h, layer.ln2)
    ff = F.silu(x @ layer.w1) * (x @ layer.w3)
    return h + ff @ layer.w2


def _qkv(h: torch.Tensor, layer: GPTBlock, rot, cfg: GPTConfig):
    """q, k (roped with the ``rope_tables`` pair ``rot``) and v."""
    b, s = h.shape[:2]
    nh, hd = cfg.n_heads, cfg.head_dim
    x = rmsnorm(h, layer.ln1)
    q = _rotate((x @ layer.wq).view(b, s, nh, hd), *rot)
    k = _rotate((x @ layer.wk).view(b, s, nh, hd), *rot)
    v = (x @ layer.wv).view(b, s, nh, hd)
    return q, k, v


def block(h, layer: GPTBlock, positions, cfg: GPTConfig,
          return_kv: bool = False):
    """One transformer block; with ``return_kv`` also hands back the
    roped K and raw V (prefill seeds a cache from the same computation)."""
    b, s, d = h.shape
    q, k, v = _qkv(h, layer, rope_tables(positions, cfg.head_dim,
                                         cfg.rope_theta), cfg)
    attn = _attention(q, k, v, positions, cfg)
    h = h + attn.reshape(b, s, d) @ layer.wo
    h = _constrain(h, cfg, (cfg.data_axis, cfg.seq_axis, None))
    if cfg.mesh is None:
        h = _mlp(h, layer)
    else:
        x = rmsnorm(h, layer.ln2)
        ff = F.silu(x @ layer.w1) * (x @ layer.w3)
        ff = _constrain(ff, cfg, (cfg.data_axis, cfg.seq_axis,
                                  cfg.model_axis))
        h = h + ff @ layer.w2
        h = _constrain(h, cfg, (cfg.data_axis, cfg.seq_axis, None))
    return (h, k, v) if return_kv else h


def forward(params: GPT, tokens: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """tokens [B,S] integer -> logits [B,S,V] float32. With a mesh,
    outside a command: one mesh command over the whole batch (see the
    module docstring); inside one: this rank's rows in, this rank's
    sequence block of logits out."""
    if cfg.mesh is not None:
        from ..parallel import world
        if not world.in_command():
            return world.run(_mesh_forward, params, tokens, cfg)
        tokens = _seq_block(tokens, cfg)
    b, s = tokens.shape
    offset = 0
    if _axis(cfg, cfg.seq_axis) > 1:
        offset = cfg.mesh.get_local_rank(cfg.seq_axis) * s
    positions = (offset + torch.arange(s, device=tokens.device)).expand(b, s)
    h = params.embed[tokens]
    h = _constrain(h, cfg, (cfg.data_axis, cfg.seq_axis, None))
    for layer in params.layers:
        h = block(h, layer, positions, cfg)
    h = rmsnorm(h, params.ln_f)
    return _constrain((h @ params.head).float(), cfg,
                      (cfg.data_axis, cfg.seq_axis, cfg.model_axis))


def _mesh_rows(tokens: torch.Tensor, cfg: GPTConfig):
    """(this rank's rows of rank 0's ``tokens``, whether rows are split)."""
    from torch.distributed.tensor import DTensor, Shard
    from ..parallel.sharding import place_local
    placed = tokens if isinstance(tokens, DTensor) else \
        place_local(tokens, cfg.mesh)
    return placed.to_local(), any(isinstance(p, Shard)
                                  for p in placed.placements)


def _whole(x: torch.Tensor, cfg: GPTConfig, rows_split: bool,
           seq_split: bool) -> torch.Tensor:
    """The whole tensor from each rank's block (rows over data, dim 1
    over seq)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    for axis, dim, split in ((cfg.seq_axis, 1, seq_split),
                             (cfg.data_axis, 0, rows_split)):
        if not split or _axis(cfg, axis) == 1:
            continue
        group = cfg.mesh.get_group(axis)
        parts = [torch.empty_like(x) for _ in range(_axis(cfg, axis))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim=dim)
    return x


def _mesh_forward(params: GPT, tokens: torch.Tensor,
                  cfg: GPTConfig) -> torch.Tensor:
    from torch.distributed.tensor.experimental import implicit_replication
    rows, split = _mesh_rows(tokens, cfg)
    with torch.no_grad(), implicit_replication():
        out = forward(params, rows, cfg)
        return _whole(out, cfg, split, _axis(cfg, cfg.seq_axis) > 1)


def loss_fn(params: GPT, batch: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """Next-token cross-entropy; batch = tokens [B,S+1] integer. With a
    mesh, outside a command: the mean over the whole batch, as one mesh
    command; inside one: the mean over this rank's block (the train
    step averages gradients and losses over ``data`` x ``seq``)."""
    if cfg.mesh is not None:
        from ..parallel import world
        if not world.in_command():
            return world.run(_mesh_loss, params, batch, cfg)
    inputs, targets = batch[:, :-1], batch[:, 1:]
    if cfg.mesh is not None:
        targets = _seq_block(targets, cfg)
    logp = torch.log_softmax(forward(params, inputs, cfg), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


def _mesh_loss(params: GPT, batch: torch.Tensor,
               cfg: GPTConfig) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from ..parallel.collectives import all_mean
    from ..parallel.mesh import replica_group
    rows, _ = _mesh_rows(batch, cfg)
    with torch.no_grad(), implicit_replication():
        loss = loss_fn(params, rows, cfg)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        return all_mean(loss, replica_group(cfg.mesh))


def _last(h: torch.Tensor, true_len, t: int) -> torch.Tensor:
    """h[:, true_len - 1] with the index clamped into [0, t-1], as JAX's
    ``dynamic_slice_in_dim`` clamps (a zero-length prompt reads row 0,
    never the padded tail); ``true_len`` may be a tensor."""
    idx = torch.as_tensor(t if true_len is None else true_len,
                          device=h.device).reshape(1).long()
    return h.index_select(1, (idx - 1).clamp(0, t - 1))[:, 0]


# -- KV-cache decode (generative path) ------------------------------------

def init_cache(cfg: GPTConfig, batch: int, max_len: int,
               device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "index": torch.zeros((), dtype=torch.long, device=device)}


def prefill(params: GPT, cache, tokens, cfg: GPTConfig, true_len=None):
    """Whole-prompt prefill in one pass: tokens [B,T] -> (logits [B,V]
    at the last real position, cache). Writes K/V at positions 0..T-1 of
    ``cache`` in place and sets its index to ``true_len`` (T when None):
    callers pad prompts to a few bucket lengths, the padded rows are
    garbage the decode loop overwrites before its mask reaches them."""
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    h = params.embed[tokens]
    for i, layer in enumerate(params.layers):
        h, k, v = block(h, layer, positions, cfg, return_kv=True)
        cache["k"][i, :, :t] = k.to(cache["k"].dtype)
        cache["v"][i, :, :t] = v.to(cache["v"].dtype)
    h = rmsnorm(h, params.ln_f)
    logits = (_last(h, true_len, t) @ params.head).float()
    cache["index"].copy_(torch.as_tensor(t if true_len is None
                                         else true_len))
    return logits, cache


def decode_step(params: GPT, cache, token, cfg: GPTConfig):
    """One-token decode for a cache with one shared index: token [B] ->
    (logits [B,V], cache); a shim over :func:`decode_step_multi` so the
    single- and multi-stream paths cannot drift."""
    b = token.shape[0]
    mcache = {"k": cache["k"], "v": cache["v"],
              "index": cache["index"].expand(b).clone()}
    active = torch.ones(b, dtype=torch.bool, device=token.device)
    logits, mcache = decode_step_multi(params, mcache, token, active, cfg)
    cache["index"].copy_(mcache["index"][0])
    return logits, cache


def init_cache_multi(cfg: GPTConfig, batch: int, max_len: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """Continuous-batching cache: per-slot positions (index [B])."""
    cache = init_cache(cfg, batch, max_len, device)
    cache["index"] = torch.zeros(batch, dtype=torch.long, device=device)
    return cache


def cache_insert(bcache, cache1, slot):
    """Put a batch-1 cache into slot ``slot`` of a multi-stream cache
    (same max_len), in place. The whole lane is replaced, so the slot's
    previous occupant cannot leak."""
    bcache["k"][:, slot] = cache1["k"][:, 0].to(bcache["k"].dtype)
    bcache["v"][:, slot] = cache1["v"][:, 0].to(bcache["v"].dtype)
    bcache["index"][slot] = cache1["index"].reshape(())
    return bcache


def decode_step_multi(params: GPT, cache, token, active, cfg: GPTConfig):
    """One decode step for B independent streams: token [B], active [B]
    bool, per-slot index [B]; writes the cache and the index in place.
    Inactive lanes and lanes at max_len neither write nor advance: each
    writes its old row back at its position clamped to max_len - 1."""
    b = token.shape[0]
    pos = cache["index"]
    max_len = cache["k"].shape[2]
    dev = token.device
    h = params.embed[token[:, None]]
    valid = torch.arange(max_len, device=dev)[None, :] <= pos[:, None]
    ok = active & (pos < max_len)
    lane = ok[:, None, None]                    # over a [B, H, Dh] row
    rows = torch.arange(b, device=dev)
    wpos = pos.clamp(max=max_len - 1)
    mask = valid[:, None, None, :]
    rot = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for i, layer in enumerate(params.layers):
        q, k1, v1 = _qkv(h, layer, rot, cfg)
        kc, vc = cache["k"][i], cache["v"][i]   # [B, L, H, Dh] views
        kc[rows, wpos] = torch.where(lane, k1[:, 0].to(kc.dtype),
                                     kc[rows, wpos])
        vc[rows, wpos] = torch.where(lane, v1[:, 0].to(vc.dtype),
                                     vc[rows, wpos])
        attn = _attend(q, kc, vc, mask, cfg.dtype)
        h = h + attn.reshape(b, 1, -1) @ layer.wo
        h = _mlp(h, layer)
    h = rmsnorm(h, params.ln_f)
    logits = (h[:, 0] @ params.head).float()
    cache["index"].add_(ok.long())
    return logits, cache


# -- sampling -------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors (xorshift-multiply rounds;
    both multipliers are below 2**31, so no product overflows int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def uniform_noise(seed: torch.Tensor, counter: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Per-stream uniform noise in (0, 1): seed [B], counter [B] int64 ->
    [B, n] float32, a pure function of (seed, counter, column) made of
    integer tensor ops, so it is the same in a captured graph, on any
    device and whatever other rows are in the batch."""
    s = _mix32(_mix32(seed & _M32) ^ (counter & _M32))
    cols = torch.arange(n, device=seed.device)
    x = _mix32(s[:, None] ^ ((cols * 0x9E3779B1) & _M32)[None, :])
    return ((x >> 8).float() + 0.5) * (2.0 ** -24)


def candidates(logits: torch.Tensor, top_k: int = 0,
               top_p: float = 1.0) -> torch.Tensor:
    """The logits with everything outside the top_k / top_p candidate
    set at -inf, formed on the unscaled distribution (llamacpp's sampler
    chain order, as the JAX ``sample_logits``). top_p <= 0 keeps the best
    token only."""
    l0 = logits.float()
    if top_k and top_k > 0:
        kth = torch.topk(l0, min(top_k, l0.shape[-1]), dim=-1).values[..., -1:]
        l0 = torch.where(l0 < kth, float("-inf"), l0)
    if top_p < 1.0:
        srt = torch.sort(l0, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        kept = torch.where((exclusive < top_p) | (exclusive <= 0.0), srt,
                           float("inf"))
        thr = kept.min(dim=-1, keepdim=True).values   # smallest kept logit
        l0 = torch.where(l0 < thr, float("-inf"), l0)
    return l0


def sample_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 1.0,
                  rng: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Per-stream sampling: logits [B,V] f32 -> tokens [B] int64.
    temperature <= 0 is greedy argmax (``rng`` unused); otherwise a
    Gumbel-max draw over :func:`candidates` scaled by ``1/temperature``,
    with noise from ``rng`` ({"seed": [B], "counter": [B]}, the stream's
    seed and the number of tokens it has drawn)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    l0 = candidates(logits, top_k, top_p)
    u = uniform_noise(rng["seed"], rng["counter"], l0.shape[-1])
    return torch.argmax(l0 / temperature - torch.log(-torch.log(u)), dim=-1)


def decode_chunk_multi(params: GPT, cache, logits, rng, active,
                       cfg: GPTConfig, *, steps: int,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0):
    """``steps`` sample+decode rounds for B streams: the loop the LLM
    filter captures as one CUDA graph. ``rng``'s counters advance once a
    step (in place) when sampling, so chunked generation draws what the
    per-token loop draws. Returns (tokens [steps, B], logits, cache, rng)."""
    toks = []
    for _ in range(steps):
        tok = sample_logits(logits, temperature, top_k, top_p, rng)
        if temperature > 0:
            rng["counter"].add_(1)
        logits, cache = decode_step_multi(params, cache, tok, active, cfg)
        toks.append(tok)
    return torch.stack(toks), logits, cache, rng


# -- paged KV pool (block-granular cache) ---------------------------------

def init_kv_pool(cfg: GPTConfig, n_blocks: int, block_size: int,
                 device=None) -> Dict[str, torch.Tensor]:
    """Block arena {"k","v"} [L, NB+1, bs, H, Dh]: blocks 0..NB-1 are the
    allocator's (filters/kvpool.py), block NB is the discard block that
    takes the guarded writes JAX drops out of range."""
    shape = (cfg.n_layers, n_blocks + 1, block_size, cfg.n_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def pool_insert(pool, kb, vb, phys):
    """Write whole blocks in place: kb/vb [L, nb, bs, H, Dh] into phys
    [nb] (ids the host allocator handed out)."""
    pool["k"][:, phys] = kb.to(pool["k"].dtype)
    pool["v"][:, phys] = vb.to(pool["v"].dtype)
    return pool


def pool_copy_block(pool, src, dst):
    """Copy-on-write helper: duplicate block ``src`` into ``dst``."""
    pool["k"][:, dst] = pool["k"][:, src]
    pool["v"][:, dst] = pool["v"][:, src]
    return pool


def pool_gather(pool, phys):
    """Gather blocks phys [nb] -> contiguous (k, v) [L, nb*bs, H, Dh]."""
    k = pool["k"][:, phys]
    v = pool["v"][:, phys]
    flat = (k.shape[0], k.shape[1] * k.shape[2], k.shape[3], k.shape[4])
    return k.reshape(flat), v.reshape(flat)


def decode_step_paged(params: GPT, pool, table, index, token, active,
                      cfg: GPTConfig, *, max_len: int):
    """One decode step for B streams whose KV lives in pool blocks.

    table [B, W] maps each stream's block index to a phys block; index
    [B] is the per-stream position. Each layer first writes the new row
    into its block (guarded lanes write into the discard block NB), then
    gathers the stream's blocks into a contiguous [B, max_len] view and
    attends over it with :func:`decode_step_multi`'s op sequence and
    layout, so the logits equal the contiguous path's bit for bit.
    Writes the pool and the index in place; returns (logits, pool,
    index)."""
    b = token.shape[0]
    discard, bs_blk = pool["k"].shape[1] - 1, pool["k"].shape[2]
    nh, hd = cfg.n_heads, cfg.head_dim
    pos = index
    dev = token.device
    h = params.embed[token[:, None]]
    valid = torch.arange(max_len, device=dev)[None, :] <= pos[:, None]
    ok = active & (pos < max_len)
    blk = (pos // bs_blk).clamp(0, table.shape[1] - 1)
    phys = table.gather(1, blk[:, None])[:, 0]
    tgt = torch.where(ok, phys, discard)
    off = pos % bs_blk
    mask = valid[:, None, None, :]
    rot = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for i, layer in enumerate(params.layers):
        q, k1, v1 = _qkv(h, layer, rot, cfg)
        pk, pv = pool["k"][i], pool["v"][i]     # [NB+1, bs, H, Dh]
        pk[tgt, off] = k1[:, 0].to(pk.dtype)
        pv[tgt, off] = v1[:, 0].to(pv.dtype)
        kc = pk[table].reshape(b, -1, nh, hd)[:, :max_len].contiguous()
        vc = pv[table].reshape(b, -1, nh, hd)[:, :max_len].contiguous()
        attn = _attend(q, kc, vc, mask, cfg.dtype)
        h = h + attn.reshape(b, 1, -1) @ layer.wo
        h = _mlp(h, layer)
    h = rmsnorm(h, params.ln_f)
    logits = (h[:, 0] @ params.head).float()
    index.add_(ok.long())
    return logits, pool, index


def decode_chunk_paged(params: GPT, pool, table, index, logits, rng, active,
                       cfg: GPTConfig, *, steps: int, max_len: int,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0):
    """:func:`decode_chunk_multi` over the paged cache. The table is a
    constant of the chunk: streams admit between chunks. Returns
    (tokens [steps, B], logits, pool, index, rng)."""
    toks = []
    for _ in range(steps):
        tok = sample_logits(logits, temperature, top_k, top_p, rng)
        if temperature > 0:
            rng["counter"].add_(1)
        logits, pool, index = decode_step_paged(
            params, pool, table, index, tok, active, cfg, max_len=max_len)
        toks.append(tok)
    return torch.stack(toks), logits, pool, index, rng


def prefill_with_past(params: GPT, past_k, past_v, past_len, tokens,
                      cfg: GPTConfig, true_len=None):
    """Suffix prefill over an existing KV prefix: run tokens [1, S]
    (``true_len`` real) with attention over the past rows and
    themselves, where past_k/past_v [L, P, H, Dh] hold ``past_len``
    valid rows (P >= past_len; the rest is never read).

    The suffix's K/V go into a [P + S] buffer at their absolute
    positions ``past_len + j``, and the mask is causal by absolute
    position, so column ``j`` is position ``j`` in every call. Returns
    (logits [1, V] at suffix position true_len-1, suffix K [L, S, H, Dh],
    suffix V)."""
    b, s = tokens.shape
    p = past_k.shape[1]
    dev = tokens.device
    p0 = torch.as_tensor(past_len, device=dev).long().reshape(())
    at = p0 + torch.arange(s, device=dev)               # [S] positions
    pos_q = at.expand(b, s)
    mask = torch.arange(p + s, device=dev)[None, None, None, :] \
        <= pos_q[:, None, :, None]
    h = params.embed[tokens]
    rot = rope_tables(pos_q, cfg.head_dim, cfg.rope_theta)
    new_k, new_v = [], []
    for i, layer in enumerate(params.layers):
        q, k, v = _qkv(h, layer, rot, cfg)
        fk = torch.cat([past_k[i][None].to(k.dtype).expand(b, -1, -1, -1),
                        torch.zeros_like(k)], dim=1).index_copy_(1, at, k)
        fv = torch.cat([past_v[i][None].to(v.dtype).expand(b, -1, -1, -1),
                        torch.zeros_like(v)], dim=1).index_copy_(1, at, v)
        attn = _attend(q, fk, fv, mask, cfg.dtype)
        h = h + attn.reshape(b, s, -1) @ layer.wo
        h = _mlp(h, layer)
        new_k.append(k)
        new_v.append(v)
    h = rmsnorm(h, params.ln_f)
    logits = (_last(h, true_len, s) @ params.head).float()
    return logits, torch.stack(new_k)[:, 0], torch.stack(new_v)[:, 0]


@register_model("gpt")
def _build_gpt(vocab: str = "32000", d_model: str = "512", n_heads: str = "8",
               n_layers: str = "6", seq: str = "128", seed: str = "0"):
    """Logit-model zoo entry: int32 token frame [S] -> float32 logits
    [S,V] (a leading batch dim passes through). Weights from a CPU
    generator seeded with ``seed``."""
    cfg = GPTConfig(vocab=int(vocab), d_model=int(d_model),
                    n_heads=int(n_heads), n_layers=int(n_layers))
    params = init_params(cfg, torch.Generator().manual_seed(int(seed)))
    s = int(seq)

    def apply_fn(m: GPT, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.dim() == 1:
            return forward(m, tokens[None].long(), cfg)[0]
        return forward(m, tokens.long(), cfg)

    in_info = TensorsInfo.make("int32", str(s))
    out_info = TensorsInfo.make("float32", f"{cfg.vocab}:{s}")
    return apply_fn, params, in_info, out_info
