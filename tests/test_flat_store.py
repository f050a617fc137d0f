"""FlatStore: upsert/delete/search/filtered-search/snapshot tests.

Mirrors the reference edge vectorstore behaviors: primary-key upsert
overwrite, delete-then-search excludes tombstones, filtered scan over
candidates, save/load roundtrip (SaveVertex/LoadVertex parity).
"""

import io

import numpy as np
import pytest

from coltt_tpu.ops.distance import Metric
from coltt_tpu.ops.quant import Quantization
from coltt_tpu.store.flat import FlatStore


def _mk(rng, n=100, dim=32, q=Quantization.NONE, metric=Metric.COSINE):
    store = FlatStore(dim, metric=metric, quantization=q)
    vecs = rng.standard_normal((n, dim), dtype=np.float32)
    for i in range(n):
        store.upsert(f"pk{i}", vecs[i])
    return store, vecs


def test_upsert_search_exact_top1(rng):
    store, vecs = _mk(rng)
    scores, slots = store.search(vecs[17], k=1)
    assert slots[0, 0] == store.pk_to_slot["pk17"]
    assert scores[0, 0] > 99.9  # self-match on cosine = 100


def test_upsert_overwrites_by_pk(rng):
    store, vecs = _mk(rng, n=10)
    assert len(store) == 10
    new_vec = rng.standard_normal(32, dtype=np.float32)
    slot_before = store.pk_to_slot["pk3"]
    store.upsert("pk3", new_vec)
    assert len(store) == 10
    assert store.pk_to_slot["pk3"] == slot_before
    _, slots = store.search(new_vec, k=1)
    assert slots[0, 0] == slot_before


def test_delete_excludes_and_reuses_slot(rng):
    store, vecs = _mk(rng, n=10)
    slot = store.pk_to_slot["pk5"]
    assert store.delete("pk5") == slot
    assert store.delete("pk5") is None
    _, slots = store.search(vecs[5], k=10)
    assert slot not in slots[0][slots[0] >= 0] or store.slot_to_pk.get(slot) != "pk5"
    scores, slots = store.search(vecs[5], k=1)
    assert slots[0, 0] != slot
    # freed slot is reused
    new_slot = store.upsert("pk_new", rng.standard_normal(32, dtype=np.float32))
    assert new_slot == slot


def test_search_matches_bruteforce(rng):
    store, vecs = _mk(rng, n=200, metric=Metric.EUCLIDEAN)
    q = rng.standard_normal((2, 32), dtype=np.float32)
    scores, slots = store.search(q, k=5)
    d = ((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d, axis=1)[:, :5]
    for i in range(2):
        got_pks = {store.slot_to_pk[s] for s in slots[i]}
        want_pks = {f"pk{j}" for j in want[i]}
        assert got_pks == want_pks


def test_filtered_search_gather_and_mask(rng):
    store, vecs = _mk(rng, n=300)
    q = vecs[42]
    # tiny candidate set -> gather regime
    cands = np.array([store.pk_to_slot[f"pk{i}"] for i in (1, 42, 99)], np.int32)
    scores, slots = store.search(q, k=2, candidates=cands)
    assert slots[0, 0] == store.pk_to_slot["pk42"]
    assert set(slots[0][slots[0] >= 0]) <= set(cands.tolist())
    # big candidate set -> masked scan regime
    cands = np.arange(0, 300, 2, dtype=np.int32)
    scores, slots = store.search(q, k=3, candidates=cands)
    assert set(slots[0][slots[0] >= 0]) <= set(cands.tolist())
    # empty candidates
    scores, slots = store.search(q, k=3, candidates=np.array([], np.int32))
    assert (slots == -1).all() and np.isneginf(scores).all()


@pytest.mark.parametrize(
    "q",
    [Quantization.F16, Quantization.BF16, Quantization.F8, Quantization.I8],
)
def test_quantized_self_retrieval(q, rng):
    store, vecs = _mk(rng, n=128, dim=64, q=q)
    scores, slots = store.search(vecs[:8], k=1)
    want = [store.pk_to_slot[f"pk{i}"] for i in range(8)]
    assert slots[:, 0].tolist() == want


def test_capacity_growth(rng):
    store = FlatStore(8, base_capacity=8192)
    vecs = rng.standard_normal((10, 8), dtype=np.float32)
    for i in range(10):
        store.upsert(f"a{i}", vecs[i])
    store._grow(20000)
    assert store.capacity >= 20000
    _, slots = store.search(vecs[7], k=1)
    assert store.slot_to_pk[int(slots[0, 0])] == "a7"


def test_snapshot_roundtrip(rng):
    store, vecs = _mk(rng, n=50, q=Quantization.F8)
    store.delete("pk7")
    buf = io.BytesIO()
    store.save(buf)
    buf.seek(0)
    back = FlatStore.load(buf)
    assert len(back) == len(store)
    assert back.quantization == Quantization.F8
    assert back.pk_to_slot == store.pk_to_slot
    s1, i1 = store.search(vecs[3], k=5)
    s2, i2 = back.search(vecs[3], k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)


def test_dim_mismatch_raises(rng):
    store = FlatStore(16)
    with pytest.raises(ValueError):
        store.upsert("x", np.zeros(8, np.float32))
    with pytest.raises(ValueError):
        store.search(np.zeros((1, 8), np.float32), k=1)


def test_get_vector_roundtrip(rng):
    store = FlatStore(16, quantization=Quantization.NONE)
    v = rng.standard_normal(16, dtype=np.float32)
    store.upsert("x", v)
    np.testing.assert_allclose(store.get_vector("x"), v, atol=1e-6)
    assert store.get_vector("nope") is None


# -- PQ-quantized store ------------------------------------------------------

def _mk_pq(rng, n=600, dim=32, **kw):
    store = FlatStore(
        dim, metric=Metric.COSINE, quantization=Quantization.PQ,
        pq_subspaces=8, pq_centroids=64, pq_train_iters=8, **kw,
    )
    centers = rng.standard_normal((16, dim)).astype(np.float32)
    vecs = (
        centers[rng.integers(0, 16, n)]
        + 0.1 * rng.standard_normal((n, dim)).astype(np.float32)
    )
    store.upsert_many([f"pk{i}" for i in range(n)], vecs)
    return store, vecs


def test_pq_store_trains_and_searches(rng):
    store, vecs = _mk_pq(rng)
    scores, slots = store.search(vecs[5], k=10)
    assert store.codebook is not None
    assert store.pqcodes.shape[1] == 8  # M subspaces, not dim
    assert store.codes.shape[1] == 32  # f8 scan cache at full dim
    # shortlist property: true row in PQ top-10 on clustered data
    assert store.pk_to_slot["pk5"] in set(slots[0].tolist())


def test_pq_nocache_matches_cache_shortlist(rng):
    cached, vecs = _mk_pq(rng)
    adc = FlatStore(
        32, metric=Metric.COSINE, quantization=Quantization.PQ,
        pq_subspaces=8, pq_centroids=64, pq_train_iters=8, pq_cache=False,
    )
    adc.upsert_many([f"pk{i}" for i in range(len(vecs))], vecs)
    adc.sync()
    assert adc.codes.shape[1] == 8  # codes ARE the pq codes, no cache
    s1, i1 = cached.search(vecs[5], k=20)
    s2, i2 = adc.search(vecs[5], k=20)
    # both modes shortlist the true row; exact ranks may differ by the
    # f8 re-quantization of the cache
    assert cached.pk_to_slot["pk5"] in set(i1[0].tolist())
    assert adc.pk_to_slot["pk5"] in set(i2[0].tolist())
    assert len(set(i1[0].tolist()) & set(i2[0].tolist())) >= 10


def test_pq_store_upsert_after_training(rng):
    store, vecs = _mk_pq(rng)
    store.search(vecs[0], k=1)  # force sync+train
    new = vecs[7] + 0.01
    store.upsert("new", new)
    # PQ codes tie within a cluster; the new row must land in the
    # cluster-sized shortlist (exact rank among ties is arbitrary)
    scores, slots = store.search(new, k=64)
    assert store.pk_to_slot["new"] in set(slots[0].tolist())


def test_pq_store_delete_and_filtered(rng):
    store, vecs = _mk_pq(rng)
    store.delete("pk5")
    scores, slots = store.search(vecs[5], k=10)
    assert -1 not in slots[0][:1]  # still returns hits
    assert store.pk_to_slot.get("pk5") is None
    # filtered gather path
    cands = np.array(
        [store.pk_to_slot[f"pk{i}"] for i in range(10, 40)], np.int32
    )
    scores, slots = store.search(vecs[12], k=5, candidates=cands)
    assert set(slots[0].tolist()) <= set(cands.tolist())


def test_pq_snapshot_roundtrip(rng):
    store, vecs = _mk_pq(rng)
    s1, i1 = store.search(vecs[3], k=5)
    buf = io.BytesIO()
    store.save(buf)
    buf.seek(0)
    loaded = FlatStore.load(buf)
    assert loaded.is_pq and loaded.codebook is not None
    s2, i2 = loaded.search(vecs[3], k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-5)


def test_pq_snapshot_load_nocache_override(rng):
    store, vecs = _mk_pq(rng)
    buf = io.BytesIO()
    store.save(buf)
    buf.seek(0)
    loaded = FlatStore.load(buf, pq_cache=False)
    assert loaded.is_pq and not loaded.pq_cache
    assert loaded.codes.shape[1] == 8
    _, i2 = loaded.search(vecs[3], k=10)
    assert loaded.pk_to_slot["pk3"] in set(i2[0].tolist())


def test_pq_get_vector_is_reconstruction(rng):
    store, vecs = _mk_pq(rng)
    got = store.get_vector("pk9")
    # reconstruction, not exact: close on clustered data
    cos = np.dot(got, vecs[9]) / (
        np.linalg.norm(got) * np.linalg.norm(vecs[9])
    )
    assert cos > 0.9


def test_bulk_build_matches_upsert(rng):
    vecs = rng.standard_normal((500, 32)).astype(np.float32)
    pks = [f"pk{i}" for i in range(500)]
    a = FlatStore(32, metric=Metric.COSINE, quantization=Quantization.F8)
    a.upsert_many(pks, vecs)
    b = FlatStore(32, metric=Metric.COSINE, quantization=Quantization.F8)
    b.bulk_build(pks, vecs)
    q = vecs[:4]
    s1, i1 = a.search(q, k=5)
    s2, i2 = b.search(q, k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-5)
    # mutation continues to work after bulk build
    b.upsert("extra", vecs[0])
    assert len(b) == 501


def test_bulk_build_pq(rng):
    store, vecs = _mk_pq(rng)
    bulk = FlatStore(
        32, metric=Metric.COSINE, quantization=Quantization.PQ,
        pq_subspaces=8, pq_centroids=64, pq_train_iters=8,
    )
    bulk.bulk_build([f"pk{i}" for i in range(len(vecs))], vecs)
    assert bulk.codebook is not None and bulk.pqcodes.shape[1] == 8
    _, idx = bulk.search(vecs[5], k=10)
    assert bulk.pk_to_slot["pk5"] in set(idx[0].tolist())


def test_bulk_build_requires_empty(rng):
    store = FlatStore(32)
    store.upsert("x", rng.standard_normal(32).astype(np.float32))
    with pytest.raises(RuntimeError):
        store.bulk_build(["a"], rng.standard_normal((1, 32)).astype(np.float32))


def test_compute_recall():
    from coltt_tpu.ops.topk import compute_recall
    r = compute_recall(np.array([[1, 2, 3], [4, 5, 6]]),
                       np.array([[1, 2, 9], [4, 5, 6]]))
    assert abs(r - 5 / 6) < 1e-9
    assert compute_recall(np.array([1, 2]), np.array([-1, -1])) == 1.0


def test_approx_recall_search(rng):
    store, vecs = _mk(rng, n=300)
    s1, i1 = store.search(vecs[11], k=5)
    s2, i2 = store.search(vecs[11], k=5, approx_recall=0.95)
    # on CPU and GPU ApproxTopK lowers to exact; where it is approximate
    # it is near-exact — the self-match must always surface
    assert i2[0, 0] == store.pk_to_slot["pk11"]
    assert len(set(i1[0].tolist()) & set(i2[0].tolist())) >= 4


def test_concurrent_upsert_search_stress():
    """Edge engines release their lock before scanning, so the store must
    be internally safe: searches racing upserts/deletes/syncs must never
    double-apply staged rows, read torn array sets, or crash."""
    import threading

    store = FlatStore(32, metric=Metric.COSINE, quantization=Quantization.F16)
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((600, 32)).astype(np.float32)
    store.bulk_build([f"p{i}" for i in range(200)], vecs[:200])

    errors = []
    stop = threading.Event()

    def writer():
        try:
            for i in range(200, 600):
                store.upsert(f"p{i}", vecs[i])
                if i % 5 == 0:
                    store.sync()
                if i % 11 == 0:
                    store.delete(f"p{i - 150}")
            store.sync()
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        qs = rng.standard_normal((4, 32)).astype(np.float32)
        try:
            while not stop.is_set():
                s, slots = store.search(qs, 5)
                ok = slots >= 0
                assert np.isfinite(s[ok]).all()
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
    # final consistency: the last row is findable, the deleted one is gone
    s, slots = store.search(vecs[599], 1)
    assert store.slot_to_pk[int(slots[0, 0])] == "p599"
    # p246 was upserted at i=246 and deleted at i=396 (396 % 11 == 0)
    assert store.pk_to_slot.get("p246") is None


def test_adopt_pq_matches_bulk_build(rng):
    """adopt_pq (the streaming bulk path for pre-encoded corpora) must
    serve identically to a store that trained/encoded the same data via
    bulk_build with the same codebook, and survive a save/load roundtrip
    with the cache rebuilt."""
    from coltt_tpu.ops.pq import pq_encode, train_pq

    n, dim = 8192, 64
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((4, dim)).astype(np.float32)

    ref = FlatStore(dim, quantization=Quantization.PQ, pq_coarse=64,
                    pq_train_iters=5)
    ref.bulk_build([str(i) for i in range(n)], vecs)
    s_ref, i_ref = ref.search(qs, 10, oversample=4)

    codes, _ = pq_encode(vecs, ref.codebook)
    adopted = FlatStore.adopt_pq(ref.codebook, codes)
    assert len(adopted) == n and adopted.capacity == n
    s_ad, i_ad = adopted.search(qs, 10, oversample=4)
    np.testing.assert_array_equal(i_ref, i_ad)
    np.testing.assert_allclose(s_ref, s_ad, rtol=1e-5)

    buf = io.BytesIO()
    adopted.save(buf)
    buf.seek(0)
    loaded = FlatStore.load(buf)
    assert loaded.capacity == n
    s_ld, i_ld = loaded.search(qs, 10, oversample=4)
    np.testing.assert_array_equal(i_ad, i_ld)
    np.testing.assert_allclose(s_ad, s_ld, rtol=1e-5)
    # mutation still works on the adopted/loaded store
    loaded.upsert("probe", np.full(dim, 0.5, np.float32))
    s, i = loaded.search(np.full(dim, 0.5, np.float32), 1)
    assert loaded.slot_to_pk[int(i[0, 0])] == "probe"


def test_pq_host_codes_mode_matches_device(rng):
    """pq_host_codes=True (authoritative codes on host, rerank gathers
    shortlist rows host-side) must serve the same results as the
    device-codes store, survive mutation, and round-trip through
    save/load with the auto host-mode threshold overridden."""
    from coltt_tpu.ops.pq import pq_encode, train_pq

    n, dim = 8192, 64
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((4, dim)).astype(np.float32)

    dev = FlatStore(dim, quantization=Quantization.PQ, pq_coarse=64,
                    pq_train_iters=5)
    dev.bulk_build([str(i) for i in range(n)], vecs)
    s_dev, i_dev = dev.search(qs, 10, oversample=4)

    codes = np.asarray(pq_encode(vecs, dev.codebook)[0])
    host = FlatStore.adopt_pq(dev.codebook, codes, pq_host_codes=True)
    assert host.pq_host and host.pqcodes is None
    assert host.memory_bytes < dev.memory_bytes  # codes off the device
    s_h, i_h = host.search(qs, 10, oversample=4)
    np.testing.assert_array_equal(i_dev, i_h)
    np.testing.assert_allclose(s_dev, s_h, rtol=1e-5)

    # mutation keeps host codes in sync
    host.upsert("probe", np.full(dim, 0.5, np.float32))
    s, i = host.search(np.full(dim, 0.5, np.float32), 1)
    assert host.slot_to_pk[int(i[0, 0])] == "probe"

    # roundtrip, forcing host mode on load despite the small size
    buf = io.BytesIO()
    host.save(buf)
    buf.seek(0)
    loaded = FlatStore.load(buf, pq_host_codes=True)
    assert loaded.pq_host
    s_ld, i_ld = loaded.search(qs, 10, oversample=4)
    s_h2, i_h2 = host.search(qs, 10, oversample=4)
    np.testing.assert_array_equal(i_h2, i_ld)
