"""Host-side bookkeeping for the paged KV pool (vLLM-style paging).

Port of ``nnstreamer_tpu/filters/kvpool.py`` (host-only: no tensor is
touched here). The device arena lives in models/transformer.py
(``init_kv_pool``, a ``[L, NB+1, bs, H, Dh]`` block tensor addressed
through per-stream block tables; block NB is the discard block). This
module owns what the device must not: the free list, per-block
refcounts, and the **content-addressed prefix cache** that lets shared
system prompts hit warm KV blocks instead of recomputing prefill.

Addressing is a block-aligned sha256 *chain*::

    h_0 = sha256(tokens[0:bs])
    h_j = sha256(hex(h_{j-1}) || tokens[j*bs:(j+1)*bs])

so a block's digest commits to the entire prefix before it: two prompts
share block ``j`` iff their first ``(j+1)*bs`` tokens are identical. The
digests equal the JAX package's for the same tokens.

Sharing discipline (what makes the in-place decode writes safe):

* only FULL prompt blocks are committed, and lookup callers cap
  adoption at ``(plen - 1) // bs`` blocks, so the first block a decode
  step writes is always stream-private: shared blocks are read-only;
* the cache holds one refcount on each committed block, active streams
  one each. Eviction (LRU, leaf-first via per-entry kid counters) only
  touches blocks whose sole reference is the cache's;
* :meth:`KVBlockPool.cow` is the copy-on-write escape hatch for a
  caller that must mutate a shared block.

Pools register in :data:`POOL_TABLE` (weakly) so obs/metrics.py can
render ``nns_kv_blocks_{free,used,cached}`` and the prefix-cache hit
ratio without holding a pool alive.
"""
from __future__ import annotations

import hashlib
import threading
import weakref
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import flowmarks as flow
from ..utils.atomic import Counters

_POOL_LOCK = threading.Lock()
POOL_TABLE: "weakref.WeakValueDictionary[str, KVBlockPool]" = \
    weakref.WeakValueDictionary()


def chain_hashes(tokens, block_size: int) -> List[str]:
    """Digest chain over the FULL blocks of ``tokens`` (partial tail
    blocks are never hashed — they are never shareable)."""
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32).ravel())
    out: List[str] = []
    prev = b""
    for j in range(arr.size // block_size):
        blk = arr[j * block_size:(j + 1) * block_size]
        h = hashlib.sha256(prev + blk.tobytes()).hexdigest()
        out.append(h)
        prev = h.encode("ascii")
    return out


class _CacheEntry:
    __slots__ = ("phys", "parent", "kids")

    def __init__(self, phys: int, parent: Optional[str]):
        self.phys = phys
        self.parent = parent
        self.kids = 0          # cached children chaining off this block


class KVBlockPool:
    """Free-list allocator + refcounts + LRU prefix cache for one
    device block arena. All methods are thread-safe; ``_lock`` is a
    LEAF lock (no method calls out while holding it)."""

    def __init__(self, n_blocks: int, block_size: int,
                 name: str = "kvpool"):
        if n_blocks < 1 or block_size < 1:
            raise ValueError("n_blocks and block_size must be >= 1")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.name = name
        self._lock = threading.RLock()
        self._free: deque = deque(range(self.n_blocks))
        self._ref = [0] * self.n_blocks
        # insertion order == LRU order; move_to_end on every touch
        self._cache: "OrderedDict[str, _CacheEntry]" = OrderedDict()
        self.stats = Counters(prefix_hits=0, prefix_misses=0,
                              prefix_evictions=0, alloc_failures=0)
        with _POOL_LOCK:
            key, n = name, 1
            while key in POOL_TABLE:
                n += 1
                key = f"{name}-{n}"
            self.name = key
            POOL_TABLE[key] = self

    # -- allocation ----------------------------------------------------

    @flow.acquires("kv-block")
    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh blocks (refcount 1 each), evicting LRU
        cache leaves as needed. None when the pool cannot satisfy the
        request even after eviction — the scheduler's admission
        backpressure signal."""
        if n <= 0:
            return []
        with self._lock:
            while len(self._free) < n and self._evict_one_locked():
                pass
            if len(self._free) < n:
                self.stats.inc("alloc_failures")
                return None
            out = [self._free.popleft() for _ in range(n)]
            for p in out:
                self._ref[p] = 1
            return out

    @flow.acquires("kv-block")
    def retain(self, phys: Sequence[int]) -> None:
        with self._lock:
            for p in phys:
                if self._ref[p] <= 0:
                    raise ValueError(f"retain of free block {p}")
                self._ref[p] += 1

    @flow.settles("kv-block")
    def release(self, phys: Sequence[int]) -> None:
        """Drop one reference per block; blocks whose count reaches
        zero return to the free list (cache-committed blocks keep the
        cache's reference and stay warm)."""
        with self._lock:
            for p in phys:
                if self._ref[p] <= 0:
                    raise ValueError(f"release of free block {p}")
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)

    @flow.acquires("kv-block")
    def cow(self, phys: int) -> tuple:
        """Copy-on-write: -> (phys', needs_copy). A sole owner keeps
        its block; a shared block costs one fresh block (the caller
        runs ``pool_copy_block(pool, phys, phys')`` on device and then
        ``release([phys])`` to drop its old reference)."""
        with self._lock:
            if self._ref[phys] <= 0:
                raise ValueError(f"cow of free block {phys}")
            if self._ref[phys] == 1:
                return phys, False
        fresh = self.alloc(1)
        if fresh is None:
            return phys, False          # degraded: caller keeps sharing
        return fresh[0], True

    # -- prefix cache --------------------------------------------------

    @flow.acquires("kv-block")
    def lookup(self, hashes: Sequence[str]) -> List[int]:
        """Adopt the longest cached consecutive prefix of ``hashes``.
        Returned blocks are retained for the caller (release when the
        stream ends) and touched to the LRU hot end. Per-block
        hit/miss counts feed the exported hit ratio."""
        out: List[int] = []
        with self._lock:
            for h in hashes:
                ent = self._cache.get(h)
                if ent is None:
                    break
                self._cache.move_to_end(h)
                self._ref[ent.phys] += 1
                out.append(ent.phys)
            self.stats.add(prefix_hits=len(out),
                           prefix_misses=len(hashes) - len(out))
        return out

    def commit(self, hashes: Sequence[str], phys: Sequence[int]) -> None:
        """Publish a stream's FULL prompt blocks under their chain
        digests. Blocks already cached (under a different stream's
        phys) are left alone; new entries take one cache reference."""
        with self._lock:
            for j, h in enumerate(hashes):
                if h in self._cache:
                    self._cache.move_to_end(h)
                    continue
                p = phys[j]
                if self._ref[p] <= 0:
                    raise ValueError(f"commit of free block {p}")
                parent = hashes[j - 1] if j else None
                ent = _CacheEntry(p, parent)
                self._ref[p] += 1
                self._cache[h] = ent
                if parent is not None:
                    pent = self._cache.get(parent)
                    if pent is not None:
                        pent.kids += 1

    def _evict_one_locked(self) -> bool:
        """Evict the LRU cache LEAF whose block is otherwise unused
        (refcount == 1, i.e. only the cache holds it). Leaf-first —
        an entry with cached kids is load-bearing for longer chains —
        and never a block an active stream still reads."""
        victim = None
        for h, ent in self._cache.items():        # LRU -> MRU order
            if ent.kids == 0 and self._ref[ent.phys] == 1:
                victim = h
                break
        if victim is None:
            return False
        ent = self._cache.pop(victim)
        if ent.parent is not None:
            pent = self._cache.get(ent.parent)
            if pent is not None:
                pent.kids -= 1
        self._ref[ent.phys] -= 1
        if self._ref[ent.phys] == 0:
            self._free.append(ent.phys)
        self.stats.inc("prefix_evictions")
        return True

    # -- introspection -------------------------------------------------

    def stats_dict(self) -> Dict[str, float]:
        with self._lock:
            free = len(self._free)
            cached = len(self._cache)
        snap = self.stats.snapshot()
        hits = snap.get("prefix_hits", 0)
        misses = snap.get("prefix_misses", 0)
        total = hits + misses
        return {"blocks_free": free,
                "blocks_used": self.n_blocks - free,
                "blocks_cached": cached,
                "prefix_hits": hits,
                "prefix_misses": misses,
                "prefix_evictions": snap.get("prefix_evictions", 0),
                "alloc_failures": snap.get("alloc_failures", 0),
                "prefix_hit_ratio": (hits / total) if total else 0.0}
