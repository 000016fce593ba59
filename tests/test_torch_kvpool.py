"""The port's KV block pool (filters/kvpool.py) against the JAX package's.

Mirrors tests/test_llm_disagg.py's TestKvPool, each case run on both
packages' ``KVBlockPool``; then the chain digests and a scripted
alloc/commit/lookup/evict sequence compared across the two, value for
value.
"""
import numpy as np
import pytest

from nnstreamer_tpu.filters import kvpool as jax_kvpool
from nnstreamer_tpu_torch.filters import kvpool

PACKAGES = {"port": kvpool, "jax": jax_kvpool}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _pool(pkg, n=8, bs=4):
    return pkg.KVBlockPool(n, bs, name="t")


def test_alloc_free_roundtrip(pkg):
    p = _pool(pkg)
    a = p.alloc(3)
    assert len(a) == 3 and len(set(a)) == 3
    assert p.stats_dict()["blocks_free"] == 5
    p.release(a)
    assert p.stats_dict()["blocks_free"] == 8


def test_exhaustion_returns_none_and_counts(pkg):
    p = _pool(pkg, n=4)
    a = p.alloc(4)
    assert p.alloc(1) is None
    assert p.stats_dict()["alloc_failures"] == 1
    p.release(a)
    assert p.alloc(1) is not None


def test_refcounts_protect_shared_blocks(pkg):
    p = _pool(pkg)
    a = p.alloc(2)
    p.retain(a)
    p.release(a)
    assert p.stats_dict()["blocks_free"] == 6  # still held once
    p.release(a)
    assert p.stats_dict()["blocks_free"] == 8
    with pytest.raises(ValueError):
        p.release(a)


def test_cow_sole_owner_keeps_block(pkg):
    p = _pool(pkg)
    (b,) = p.alloc(1)
    assert p.cow(b) == (b, False)


def test_cow_shared_block_allocates(pkg):
    p = _pool(pkg)
    (b,) = p.alloc(1)
    p.retain([b])
    nb, need_copy = p.cow(b)
    assert need_copy and nb != b


def test_chain_hashes_full_blocks_only(pkg):
    assert pkg.chain_hashes([1, 2, 3], 4) == []
    h1 = pkg.chain_hashes([1, 2, 3, 4], 4)
    h2 = pkg.chain_hashes([1, 2, 3, 4, 9, 9, 9], 4)
    assert len(h1) == 1 and h1 == h2  # tail never hashed


def test_chain_diverges_with_prefix(pkg):
    a = pkg.chain_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    b = pkg.chain_hashes([9, 2, 3, 4, 5, 6, 7, 8], 4)
    # same second block, different first: block 1's digest differs too
    assert a[0] != b[0] and a[1] != b[1]


def test_lookup_commit_and_hit_accounting(pkg):
    p = _pool(pkg, n=8, bs=4)
    hs = pkg.chain_hashes(list(range(8)), 4)
    blocks = p.alloc(2)
    p.commit(hs, blocks)
    got = p.lookup(hs)
    assert got == blocks
    d = p.stats_dict()
    assert d["prefix_hits"] == 2 and d["blocks_cached"] == 2
    p.release(got)       # stream's refs
    p.release(blocks)    # original stream's refs
    assert p.stats_dict()["blocks_cached"] == 2   # the cache keeps them


def test_lookup_stops_at_first_miss(pkg):
    p = _pool(pkg, n=8, bs=4)
    hs = pkg.chain_hashes(list(range(12)), 4)
    blocks = p.alloc(2)
    p.commit(hs[:2], blocks)
    got = p.lookup([hs[0], "nope", hs[1]])
    assert got == [blocks[0]]   # consecutive prefix only
    p.release(got)


def test_eviction_is_lru_and_leaf_first(pkg):
    p = _pool(pkg, n=4, bs=4)
    ha = pkg.chain_hashes(list(range(8)), 4)          # chain a: 2 blocks
    ba = p.alloc(2)
    p.commit(ha, ba)
    p.release(ba)
    hb = pkg.chain_hashes(list(range(100, 104)), 4)   # chain b: 1 block
    bb = p.alloc(1)
    p.commit(hb, bb)
    p.release(bb)
    p.release(p.lookup(hb))          # chain b becomes MRU
    got = p.alloc(3)                 # evicts a's leaf, then a's root
    assert got is not None
    assert p.stats_dict()["prefix_evictions"] == 2
    assert p.lookup(hb) != []        # the MRU chain survived


def test_active_stream_block_never_evicted(pkg):
    p = _pool(pkg, n=2, bs=4)
    hs = pkg.chain_hashes(list(range(4)), 4)
    b = p.alloc(1)
    p.commit(hs, b)            # cached AND held by the stream
    assert p.alloc(2) is None  # cannot evict a live block
    p.release(b)
    assert p.alloc(2) is not None  # now evictable


def test_chain_digests_equal_the_jax_package():
    rng = np.random.default_rng(0)
    for n, bs in ((64, 16), (57, 8), (7, 4), (1, 1)):
        toks = rng.integers(0, 32000, n).astype(np.int32)
        assert kvpool.chain_hashes(toks, bs) == \
            jax_kvpool.chain_hashes(toks, bs)


def test_scripted_sequence_matches_the_jax_package():
    """The same alloc/commit/lookup/release/evict script on both pools:
    the same block ids at every step and the same stats at the end."""
    def script(pkg):
        p = pkg.KVBlockPool(6, 4, name="s")
        trace = []
        chains = [pkg.chain_hashes(list(range(s, s + 12)), 4)
                  for s in (0, 50, 0)]
        held = []
        for hs in chains:
            got = p.lookup(hs)
            fresh = p.alloc(3 - len(got))
            trace.append((list(got), fresh))
            if fresh is None:
                p.release(got)
                continue
            p.commit(hs, list(got) + fresh)
            held.append(list(got) + fresh)
        for blocks in held:
            p.release(blocks)
        trace.append(p.alloc(6))
        return trace, p.stats_dict()

    assert script(kvpool) == script(jax_kvpool)
