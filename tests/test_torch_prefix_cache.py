"""The port's shared-prefix block pool against the JAX package's.

Each scenario of ``tests/test_serving.py``'s pool tests (share and
release, double free, abandon, copy on divergence, in-flight blocks not
shared, LRU eviction) runs the same operation sequence on a
:class:`trlx_tpu.serving.prefix_cache.PrefixBlockPool` and on the port's,
recording after every operation the plan's maps and block lists, every
node's refcount and readiness, the free list and ``stats()``; the two
records must be equal, and each scenario's own assertions hold on the
port's pool. Pure host code: exact equality, no tolerance.
"""

import numpy as np
import pytest

import trlx_tpu.serving.prefix_cache as jax_pool
import trlx_tpu_torch.serving.prefix_cache as port_pool


def _cols(*blocks):
    """Flatten per-block (ids, mask) pairs into column arrays."""
    ids = [t for b in blocks for t in b[0]]
    mask = [m for b in blocks for m in b[1]]
    return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


B0 = ((1, 2), (1, 1))
B1 = ((3, 4), (1, 1))
B2 = ((9, 9), (1, 1))
PADDED = ((0, 5), (0, 1))  # a left-padded block: keyed on ids AND mask


class Recorder:
    """Runs one scenario against one package's pool and records what it
    observes."""

    def __init__(self, mod, pool_blocks, block_size, n_blocks):
        self.mod = mod
        self.pool = mod.PrefixBlockPool(pool_blocks, block_size=block_size, n_blocks=n_blocks)
        self.log = []

    def snapshot(self, tag):
        nodes = {
            b: (n.refcount, n.ready, sorted(c.block_id for c in n.children.values()))
            for b, n in sorted(self.pool._nodes.items())
        }
        self.log.append((tag, nodes, sorted(self.pool._free), self.pool.stats(),
                         [list(c) for c in self.pool.ready_chains()]))

    def plan(self, *blocks, **kw):
        p = self.pool.plan_admission(*_cols(*blocks), **kw)
        self.log.append(("plan", p.shared_map.tolist(), p.publish_map.tolist(),
                         list(p.acquired), list(p.published), p.hit_blocks))
        self.snapshot("after plan")
        return p

    def call(self, name, blocks):
        getattr(self.pool, name)(blocks)
        self.snapshot(name)


def share_and_release(r):
    a = r.plan(B0, B1)
    assert list(a.publish_map[:2]) == a.published == a.acquired and a.hit_blocks == 0
    r.call("mark_ready", a.published)
    b = r.plan(B0, B1)
    assert b.hit_blocks == 2 and b.published == []
    assert list(b.shared_map[:2]) == a.published and list(b.publish_map[:2]) == [-1, -1]
    r.call("release", a.acquired)
    r.call("release", b.acquired)
    assert r.pool.stats()["prefix_pool/hit_rate"] == 0.5


def double_free(r):
    a = r.plan(B0)
    r.call("release", a.acquired)
    with pytest.raises(r.mod.DoubleFreeError):
        r.pool.release(a.acquired)
    r.snapshot("after double free")


def abandon(r):
    a = r.plan(B0, B1)
    assert r.pool.free_blocks == 0
    r.call("abandon", a.acquired)  # the submit failed: mark_ready never came
    assert r.pool.free_blocks == 2
    b = r.plan(B0, B1)  # not stuck private
    assert len(b.published) == 2
    r.call("mark_ready", b.published)
    c = r.plan(B0, B1)
    assert c.hit_blocks == 2
    r.call("abandon", c.acquired)  # drops the refcount only: still cached
    assert r.pool.free_blocks == 0
    assert r.plan(B0, B1).hit_blocks == 2


def copy_on_divergence(r):
    a = r.plan(B0, B1)
    r.call("mark_ready", a.published)
    b = r.plan(B0, B2)  # diverges at block 1
    assert b.shared_map[0] == a.published[0] and b.publish_map[1] not in a.published
    r.call("mark_ready", b.published)
    c = r.plan(B0, B1)  # the original chain, untouched by b
    assert c.hit_blocks == 2 and list(c.shared_map[:2]) == a.published


def inflight_not_shared(r):
    r.plan(B0)  # publisher, not marked ready
    b = r.plan(B0)
    assert b.hit_blocks == 0 and list(b.shared_map) == [-1, -1] and b.published == []


def lru_eviction(r):
    a = r.plan(B0, B1)
    r.call("mark_ready", a.published)
    c = r.plan(B2)  # pool full, every block referenced
    assert c.published == [] and c.shared_map[0] == -1
    r.call("release", a.acquired)  # refcount 0: evictable
    d = r.plan(B2)
    assert len(d.published) == 1 and r.pool.evictions >= 1
    e = r.plan(B0, B1)  # leaf-first: the chain's tail went, its root stayed
    assert e.hit_blocks == 1 and e.shared_map[1] == -1 and e.published == []


def padded_and_eligible(r):
    """Left padding keys on the mask too, and ``eligible_blocks`` caps the
    walk (the server passes Q // block_size)."""
    a = r.plan(PADDED, B1, B2, eligible_blocks=2)
    assert a.publish_map[2] == -1 and len(a.published) == 2
    r.call("mark_ready", a.published)
    b = r.plan(((7, 5), (1, 1)), B1)  # same ids, another mask: no share
    assert b.hit_blocks == 0
    c = r.plan(PADDED, B1)
    assert c.hit_blocks == 2
    assert [5, 3, 4] in r.pool.ready_chains()


SCENARIOS = {
    # name: (scenario, pool_blocks, block_size, n_blocks)
    "share_and_release": (share_and_release, 4, 2, 4),
    "double_free": (double_free, 2, 2, 2),
    "abandon": (abandon, 2, 2, 2),
    "copy_on_divergence": (copy_on_divergence, 6, 2, 4),
    "inflight_not_shared": (inflight_not_shared, 4, 2, 2),
    "lru_eviction": (lru_eviction, 2, 2, 2),
    "padded_and_eligible": (padded_and_eligible, 8, 2, 4),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pool_matches_the_jax_pool(name):
    scenario, *geometry = SCENARIOS[name]
    logs = []
    for mod in (jax_pool, port_pool):
        rec = Recorder(mod, *geometry)
        scenario(rec)
        logs.append(rec.log)
    want, got = logs
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w


def test_version_counts_changes_to_the_ready_chains():
    """The port's ``version`` (the trie drafter's index key) moves when a
    block turns ready or a ready block leaves the trie, and not when a
    not-ready publish is planned or abandoned."""
    pool = port_pool.PrefixBlockPool(2, block_size=2, n_blocks=2)
    a = pool.plan_admission(*_cols(B0, B1))
    assert pool.version == 0
    pool.mark_ready(a.published)
    assert pool.version == 2
    pool.mark_ready(a.published)  # already ready: no change
    assert pool.version == 2
    pool.release(a.acquired)
    c = pool.plan_admission(*_cols(B2))  # evicts the ready tail
    assert pool.version == 3
    pool.abandon(c.acquired)  # never ready: the chains did not change
    assert pool.version == 3 and pool.free_blocks == 1
