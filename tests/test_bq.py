"""BQ (binary quantization) mode: packing, Hamming scan, store integration.

The reference reserves Quantization_BQ in its protos but never shipped it
(SURVEY.md §2.5 / VERDICT round 1 item 5); these tests define the contract
our implementation adds: exact bit packing, Hamming = popcount(xor) ground
truth, angle-estimate ranking, shortlist+rerank recall on a clustered
corpus, and full store lifecycle (upsert/delete/filter/snapshot).
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest

from coltt_tpu.ops.bq import (
    bq_decode,
    bq_encode,
    bq_scan_neg_topk,
    bq_words,
    hamming_to_neg_cos_dist,
)
from coltt_tpu.ops.distance import Metric
from coltt_tpu.ops.quant import Quantization
from coltt_tpu.ops.topk import compute_recall
from coltt_tpu.store.flat import FlatStore


def _clustered(rng, n, d, n_clusters=32, noise=0.25):
    """Cluster-mixture corpus (i.i.d. gaussian is adversarial for every
    shortlist method — distance concentration on i.i.d. data)."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    which = rng.integers(0, n_clusters, n)
    x = centers[which] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32)


def test_encode_matches_numpy_packing():
    rng = np.random.default_rng(0)
    for d in (32, 64, 768, 100):  # 100: D % 32 != 0 (padding path)
        x = rng.standard_normal((7, d)).astype(np.float32)
        packed = np.asarray(bq_encode(x))
        assert packed.shape == (7, bq_words(d))
        assert packed.dtype == np.uint32
        # numpy ground truth
        w = bq_words(d)
        xp = np.zeros((7, w * 32), np.float32)
        xp[:, :d] = x
        bits = (xp > 0).astype(np.uint64).reshape(7, w, 32)
        expect = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        np.testing.assert_array_equal(packed, expect)


def test_decode_roundtrips_signs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 130)).astype(np.float32)
    rec = np.asarray(bq_decode(bq_encode(x), 130))
    np.testing.assert_array_equal(rec, np.where(x > 0, 1.0, -1.0))


def test_hamming_scan_matches_numpy():
    rng = np.random.default_rng(2)
    codes = rng.standard_normal((256, 64)).astype(np.float32)
    queries = rng.standard_normal((4, 64)).astype(np.float32)
    cp = bq_encode(codes)
    qp = bq_encode(queries)
    valid = np.ones(256, bool)
    valid[10] = False
    negh, ids = bq_scan_neg_topk(qp, cp, jnp.asarray(valid), k=256)
    negh, ids = np.asarray(negh), np.asarray(ids)
    # numpy Hamming
    qb = (queries > 0)
    cb = (codes > 0)
    h = (qb[:, None, :] != cb[None, :, :]).sum(-1)
    for qi in range(4):
        order = np.asarray(ids[qi])
        got = -negh[qi]
        finite = np.isfinite(got)
        np.testing.assert_array_equal(got[finite], h[qi][order[finite]])
        assert np.all(np.diff(got[finite]) >= 0)  # ascending Hamming
        assert 10 not in set(order[finite].tolist())  # tombstone masked


def test_blocked_scan_equals_unblocked(monkeypatch):
    """The blocked path must engage for real (ADVICE r2: the original
    version of this test monkeypatched after the first trace, so the jit
    cache served the unblocked executable and _block_count was never
    re-read — the blocked code shipped with zero coverage). Shapes are
    chosen so blocking genuinely activates: n=32768, w=4, q=3 at a 768 KB
    budget gives need=2 <= units=4 -> 2 row blocks."""
    import coltt_tpu.ops.bq as bqmod

    rng = np.random.default_rng(3)
    codes = bq_encode(rng.standard_normal((32768, 128)).astype(np.float32))
    q = bq_encode(rng.standard_normal((3, 128)).astype(np.float32))
    ref_h, ref_i = map(np.asarray, bq_scan_neg_topk(q, codes, None, k=10))
    monkeypatch.setattr(bqmod, "_BQ_TRANSIENT_BYTES", 786432)
    assert bqmod._block_count(32768, 3, 4) == 2  # blocking engages
    # _block_count is read at trace time; drop the cached unblocked trace
    bq_scan_neg_topk.clear_cache()
    got_h, got_i = map(np.asarray, bq_scan_neg_topk(q, codes, None, k=10))
    np.testing.assert_array_equal(ref_h, got_h)
    # ids may tie-swap at equal Hamming; compare as sets per row
    for r in range(3):
        assert set(got_i[r]) == set(ref_i[r])
    bq_scan_neg_topk.clear_cache()  # don't leak the tiny-budget trace


def test_blocked_scan_query_split(monkeypatch):
    """When even the finest 8192-row blocks exceed the budget (big Q x W),
    bq_scan_neg_topk must split the query axis rather than fall back to an
    unblocked scan (ADVICE r2: the fallback reintroduced the full [Q,N,W]
    transient the budget exists to bound). n=16384, q=64, w=4 at a 64 KB
    budget: need=256 > units=2 -> 2 row blocks + 64 query parts of 1."""
    import coltt_tpu.ops.bq as bqmod

    rng = np.random.default_rng(13)
    codes = bq_encode(rng.standard_normal((16384, 128)).astype(np.float32))
    q = bq_encode(rng.standard_normal((64, 128)).astype(np.float32))
    valid = np.ones(16384, bool)
    valid[42] = False
    jvalid = jnp.asarray(valid)
    ref_h, ref_i = map(np.asarray, bq_scan_neg_topk(q, codes, jvalid, k=10))
    monkeypatch.setattr(bqmod, "_BQ_TRANSIENT_BYTES", 64 << 10)
    assert bqmod._block_count(16384, 64, 4) == 2  # clamped to units
    bq_scan_neg_topk.clear_cache()
    got_h, got_i = map(np.asarray, bq_scan_neg_topk(q, codes, jvalid, k=10))
    np.testing.assert_array_equal(ref_h, got_h)
    for r in range(64):
        assert set(got_i[r]) == set(ref_i[r])
    bq_scan_neg_topk.clear_cache()


def test_bq_recall_with_rerank():
    rng = np.random.default_rng(4)
    n, d, k = 16384, 256, 10
    vecs = _clustered(rng, n, d)
    queries = vecs[rng.integers(0, n, 16)] + 0.05 * rng.standard_normal(
        (16, d)
    ).astype(np.float32)

    exact = FlatStore(d, quantization=Quantization.NONE)
    exact.bulk_build([str(i) for i in range(n)], vecs)
    _, gt = exact.search(queries, k)

    bq = FlatStore(d, quantization=Quantization.BQ)
    bq.bulk_build([str(i) for i in range(n)], vecs)
    _, got = bq.search(queries, k)
    r = compute_recall(got, gt)
    assert r >= 0.9, f"BQ+rerank recall {r}"

    # memory: packed bits are 32x under f32; the bf16 rerank copy adds 2D
    # bytes (but only the bits are scanned — HBM traffic is the 32x figure)
    assert bq.memory_bytes < exact.memory_bytes * 0.6

    # f8 rerank copy: another ~2x memory down, recall trade documented
    bq8 = FlatStore(d, quantization=Quantization.BQ,
                    bq_rerank_dtype=Quantization.F8)
    bq8.bulk_build([str(i) for i in range(n)], vecs)
    _, got8 = bq8.search(queries, k)
    assert compute_recall(got8, gt) >= 0.7
    assert bq8.memory_bytes < bq.memory_bytes

    # no-rerank mode ranks on the angle estimate alone — weaker but sane
    raw = FlatStore(d, quantization=Quantization.BQ, bq_rerank=False)
    raw.bulk_build([str(i) for i in range(n)], vecs)
    _, got_raw = raw.search(queries, k * 4)
    r_raw = compute_recall(got_raw[:, : k * 4], gt)
    # sanity, not serving-grade: chance recall@40 here is 0.24%; this
    # corpus (few large clusters) is the worst case for sign-only ranking
    assert r_raw >= 0.2, f"BQ raw recall@{k}x4 {r_raw}"


def test_bq_store_lifecycle_and_snapshot():
    rng = np.random.default_rng(5)
    d = 96
    store = FlatStore(d, quantization=Quantization.BQ, bq_oversample=8)
    vecs = rng.standard_normal((64, d)).astype(np.float32)
    for i in range(64):
        store.upsert(f"pk{i}", vecs[i])
    store.delete("pk3")
    scores, slots = store.search(vecs[:4], 5)
    assert slots.shape == (4, 5)
    # self-match: pk_i's own vector must rank first (exact bits + f8 rerank)
    assert store.slot_to_pk[int(slots[0, 0])] == "pk0"
    assert all(store.slot_to_pk.get(int(s)) != "pk3" for s in slots.ravel() if s >= 0)
    # scores on the 0-100 scale (self-match may exceed 100 by bf16 rounding
    # of dot/|q||c|, same as the reference's unclamped fp formula)
    assert 0.0 <= scores[0, 0] <= 100.1

    # get_vector returns the f8 rerank copy (close to the original)
    got = store.get_vector("pk7")
    cos = got @ vecs[7] / (np.linalg.norm(got) * np.linalg.norm(vecs[7]))
    assert cos > 0.98

    # filtered search, gather regime (small candidate set)
    cands = np.array([store.pk_to_slot["pk1"], store.pk_to_slot["pk2"]], np.int32)
    _, fslots = store.search(vecs[1:2], 2, candidates=cands)
    assert store.slot_to_pk[int(fslots[0, 0])] == "pk1"

    # snapshot round trip preserves codes + rerank copy
    buf = io.BytesIO()
    store.save(buf)
    buf.seek(0)
    loaded = FlatStore.load(buf)
    assert loaded.is_bq and loaded.bq_rerank and loaded.bq_oversample == 8
    s2, i2 = loaded.search(vecs[:4], 5)
    np.testing.assert_array_equal(slots, i2)
    np.testing.assert_allclose(scores, s2, rtol=1e-5)


def test_bq_rejects_non_cosine():
    with pytest.raises(ValueError):
        FlatStore(64, quantization=Quantization.BQ, metric=Metric.EUCLIDEAN)


def test_mxu_hamming_path_matches_popcount():
    """The ±1-matmul Hamming scan (dot = W*32 - 2*ham) must agree EXACTLY
    with the popcount path — same negated Hamming values, same winners —
    including tombstones and dims that are not multiples of 32 (padding
    bits decode to -1 on both sides: a constant dot offset)."""
    import coltt_tpu.ops.bq as bq_mod
    from coltt_tpu.ops.bq import bq_encode, bq_scan_neg_topk

    rng = np.random.default_rng(17)
    for dim in (96, 100):  # multiple of 32 and not
        n, q, k = 16384, 8, 12
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        queries = rng.standard_normal((q, dim)).astype(np.float32)
        codes = bq_encode(jnp.asarray(vecs))
        qp = bq_encode(jnp.asarray(queries))
        valid = np.ones(n, bool)
        valid[::5] = False

        old = bq_mod._BQ_TRANSIENT_BYTES
        try:
            # force the blocked regime so the matmul branch engages
            bq_mod._BQ_TRANSIENT_BYTES = 1 << 18
            neg_m, ids_m = bq_scan_neg_topk(qp, codes, jnp.asarray(valid),
                                            k=k)
        finally:
            bq_mod._BQ_TRANSIENT_BYTES = old
        # popcount path: budget large enough for the single-block form
        neg_p, ids_p = bq_scan_neg_topk(qp, codes, jnp.asarray(valid), k=k)
        np.testing.assert_array_equal(np.asarray(neg_m), np.asarray(neg_p))
        # ids may differ among exact Hamming ties; the (value, set) pair
        # must agree per rank-plateau — check via per-row multisets
        for r in range(q):
            assert sorted(np.asarray(neg_m)[r]) == sorted(np.asarray(neg_p)[r])
            # winners at strictly-better values must match
            mset = set(np.asarray(ids_m)[r].tolist())
            pset = set(np.asarray(ids_p)[r].tolist())
            # all ids valid and non-tombstoned where finite
            for i, v in zip(np.asarray(ids_m)[r], np.asarray(neg_m)[r]):
                if np.isfinite(v):
                    assert valid[i]


def test_mxu_capped_block_keep_preserves_shortlist():
    """Deep-oversample fix (r5): in approx mode the matmul multi-block path
    keeps only max(64, 8*kk/blocks) rows per block instead of kk — the
    kk-wide per-block selection + blocks*kk-wide final sort dominated the
    10M scan at oversample 64. With winners spread across blocks (any
    non-adversarial layout) the merged top-kk must equal the exact one;
    exact=True keeps the uncapped width."""
    import coltt_tpu.ops.bq as bq_mod
    from coltt_tpu.ops.bq import bq_encode, bq_scan_neg_topk

    rng = np.random.default_rng(23)
    n, dim, q, kk = 131072, 128, 4, 640
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((q, dim)).astype(np.float32)
    codes = bq_encode(jnp.asarray(vecs))
    qp = bq_encode(jnp.asarray(queries))

    old = bq_mod._BQ_TRANSIENT_BYTES
    try:
        bq_mod._BQ_TRANSIENT_BYTES = 3 << 20  # force ~16 blocks (matmul path)
        bq_scan_neg_topk.clear_cache()
        neg_c, ids_c = map(np.asarray,
                           bq_scan_neg_topk(qp, codes, None, k=kk))
        neg_e, ids_e = map(np.asarray,
                           bq_scan_neg_topk(qp, codes, None, k=kk,
                                            exact=True))
    finally:
        bq_mod._BQ_TRANSIENT_BYTES = old
        bq_scan_neg_topk.clear_cache()
    # the capped run must produce the exact Hamming value profile
    np.testing.assert_array_equal(neg_c, neg_e)
    # and the same winners modulo equal-Hamming ties
    for r in range(q):
        assert sorted(neg_c[r]) == sorted(neg_e[r])
        strict = neg_e[r] > neg_e[r].min()  # above the tie plateau
        assert set(ids_e[r][strict]) <= set(ids_c[r])
