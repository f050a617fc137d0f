"""Distributed search tests on the virtual 8-device CPU mesh.

The distributed-equivalence tests the reference never had (SURVEY.md §4
takeaway): sharded results must equal single-device results exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coltt_tpu.ops.distance import Metric
from coltt_tpu.ops.quant import Quantization
from coltt_tpu.ops.topk import scan_topk
from coltt_tpu.parallel.dist_search import DistributedFlatIndex, sharded_scan_topk
from coltt_tpu.parallel.mesh import make_mesh, shard_spec


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, d = 4096, 64
    vecs = rng.standard_normal((n, d), dtype=np.float32)
    qs = rng.standard_normal((8, d), dtype=np.float32)
    return vecs, qs


def test_mesh_shapes():
    m = make_mesh()
    assert m.shape["shard"] == 8 and m.shape["batch"] == 1
    m = make_mesh(batch=2)
    assert m.shape["shard"] == 4 and m.shape["batch"] == 2
    with pytest.raises(ValueError):
        make_mesh(num_shards=16, batch=2)


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN])
def test_sharded_equals_single_device(data, metric):
    vecs, qs = data
    mesh = make_mesh()
    idx = DistributedFlatIndex(mesh, vecs, metric=metric)
    ds, di = idx.search(qs, k=10)

    sqn = jnp.sum(jnp.asarray(vecs) ** 2, axis=1)
    ss, si = scan_topk(
        qs, jnp.asarray(vecs), None, sqn, jnp.ones(len(vecs), bool),
        k=10, metric=metric, compute_dtype=jnp.float32,
    )
    ss, si = np.asarray(ss), np.asarray(si)
    np.testing.assert_allclose(ds, ss, rtol=1e-5, atol=1e-5)
    # ids equal where scores are strictly ordered (ties may swap)
    for qi in range(len(qs)):
        assert set(di[qi]) == set(si[qi]) or np.allclose(
            np.sort(ds[qi]), np.sort(ss[qi]), atol=1e-5
        )


def test_sharded_with_batch_axis(data):
    vecs, qs = data
    mesh = make_mesh(batch=2)  # 4 shards x 2 query groups
    idx = DistributedFlatIndex(mesh, vecs)
    ds, di = idx.search(qs, k=5)
    mesh1 = make_mesh()
    idx1 = DistributedFlatIndex(mesh1, vecs)
    d1, i1 = idx1.search(qs, k=5)
    np.testing.assert_allclose(ds, d1, rtol=1e-5, atol=1e-5)


def test_unpadded_row_count(data):
    vecs, qs = data
    mesh = make_mesh()
    # 4097 rows does not divide 8 -> padding row must never be returned
    vecs_odd = np.concatenate([vecs, vecs[:1] * 100.0])
    idx = DistributedFlatIndex(mesh, vecs_odd)
    ds, di = idx.search(qs, k=10)
    assert (di < len(vecs_odd)).all()
    assert (di >= 0).all()


def test_quantized_sharded(data):
    vecs, qs = data
    mesh = make_mesh()
    idx = DistributedFlatIndex(mesh, vecs, quantization=Quantization.F8)
    ds, di = idx.search(qs[:2], k=10)
    idxf = DistributedFlatIndex(mesh, vecs, quantization=Quantization.NONE)
    dsf, dif = idxf.search(qs[:2], k=10)
    # f8 recall@10 vs fp32 should be high even on random data
    recall = np.mean([len(set(di[i]) & set(dif[i])) / 10 for i in range(2)])
    assert recall >= 0.8


def test_odd_query_batch_padding(data):
    vecs, qs = data
    mesh = make_mesh(batch=2)
    idx = DistributedFlatIndex(mesh, vecs)
    ds, di = idx.search(qs[:3], k=4)  # 3 does not divide batch=2
    assert ds.shape == (3, 4) and di.shape == (3, 4)


def test_sharded_store_placement(data):
    """FlatStore accepts a sharded placement and still searches correctly."""
    from coltt_tpu.store.flat import FlatStore

    vecs, qs = data
    mesh = make_mesh()
    store = FlatStore(64, sharding=shard_spec(mesh), base_capacity=8192)
    store.upsert_many([f"p{i}" for i in range(256)], vecs[:256])
    scores, slots = store.search(vecs[17], k=1)
    assert store.slot_to_pk[int(slots[0, 0])] == "p17"


def test_sharded_pq_equals_single_device(data):
    from coltt_tpu.ops.pq import pq_encode, pq_scan_topk, train_pq
    from coltt_tpu.parallel.dist_search import DistributedPQIndex

    vecs, qs = data
    mesh = make_mesh()
    idx = DistributedPQIndex(mesh, vecs, metric=Metric.COSINE, m=8,
                             train_sample=2048)
    s_dist, i_dist = idx.search(qs, k=10)

    codes, sqn = pq_encode(jnp.asarray(vecs), idx.codebook)
    s_one, i_one = pq_scan_topk(
        jnp.asarray(qs), codes, idx.codebook, sqn,
        jnp.ones(len(vecs), bool), k=10, metric=Metric.COSINE,
    )
    np.testing.assert_array_equal(i_dist, np.asarray(i_one))
    np.testing.assert_allclose(s_dist, np.asarray(s_one), atol=1e-3)


def test_sharded_pq_recall_on_clustered(rng):
    """ADC over sharded codes finds true neighbors on clustered data."""
    from coltt_tpu.parallel.dist_search import DistributedPQIndex

    n, d, nc = 4096, 64, 32
    centers = rng.standard_normal((nc, d)).astype(np.float32) * 5.0
    vecs = centers[rng.integers(0, nc, n)] + 0.1 * rng.standard_normal(
        (n, d)
    ).astype(np.float32)
    mesh = make_mesh()
    idx = DistributedPQIndex(mesh, vecs, m=8, train_sample=2048)
    qi = rng.integers(0, n, 8)
    s, ids = idx.search(vecs[qi] .astype(np.float32), k=1)
    # PQ reconstructions cluster-collapse; top hit must share the cluster
    sim = vecs[qi] @ vecs.T
    for row, q in enumerate(qi):
        assert ids[row, 0] >= 0
        got, want = ids[row, 0], int(np.argmax(sim[row]))
        assert np.dot(vecs[got], vecs[want]) > 0.8 * np.dot(vecs[want], vecs[want])


def test_sharded_cflat_equals_store(rng):
    from coltt_tpu.parallel.dist_search import sharded_cflat_topk
    from coltt_tpu.store.multivec import MultiVectorStore

    n, d1, d2 = 1024, 32, 16
    v1 = rng.standard_normal((n, d1)).astype(np.float32)
    v2 = rng.standard_normal((n, d2)).astype(np.float32)
    store = MultiVectorStore({"text": d1, "image": d2}, metric=Metric.COSINE)
    for i in range(n):
        store.upsert(f"pk{i}", {"text": v1[i], "image": v2[i]})
    store.sync()

    q1 = rng.standard_normal(d1).astype(np.float32)
    q2 = rng.standard_normal(d2).astype(np.float32)
    want_s, want_i = store.search([("text", q1, 60.0), ("image", q2, 40.0)], k=10)

    mesh = make_mesh()
    spec = shard_spec(mesh)
    cap = store.capacity
    field_state = tuple(
        (jax.device_put(store.codes[f], spec),
         jax.device_put(store.scale[f], spec),
         jax.device_put(store.sqnorm[f], spec))
        for f in ("text", "image")
    )
    valid = jax.device_put(store.valid, spec)
    from coltt_tpu.parallel.mesh import batch_spec
    bs = batch_spec(mesh)
    queries = (
        jax.device_put(jnp.asarray(q1)[None, :], bs),
        jax.device_put(jnp.asarray(q2)[None, :], bs),
    )
    got_s, got_i = sharded_cflat_topk(
        mesh, field_state, valid, queries,
        (jnp.float32(0.6), jnp.float32(0.4)),
        k=10, metric=Metric.COSINE, compute_dtype=jnp.float32,
    )
    got_s, got_i = np.asarray(got_s)[0], np.asarray(got_i)[0]
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=1e-3)


def test_rerank_restores_fp32_ranking(rng):
    """f8 scan + bf16 rerank must match fp32 ground truth better than the
    raw f8 scan (the headline recall lever)."""
    from coltt_tpu.ops.topk import compute_recall

    n, d = 8192, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((16, d)).astype(np.float32)
    sim = (qs @ vecs.T) / np.linalg.norm(vecs, axis=1)
    truth = np.argsort(-sim, axis=1)[:, :10]

    mesh = make_mesh()
    raw = DistributedFlatIndex(mesh, vecs, quantization=Quantization.F8)
    rr = DistributedFlatIndex(
        mesh, vecs, quantization=Quantization.F8, rerank_dtype=jnp.float32,
    )
    _, ids_raw = raw.search(qs, k=10)
    _, ids_rr = rr.search(qs, k=10, oversample=8)
    r_raw = compute_recall(ids_raw, truth)
    r_rr = compute_recall(ids_rr, truth)
    assert r_rr >= r_raw
    assert r_rr >= 0.99, f"rerank recall {r_rr} (raw {r_raw})"


@pytest.mark.parametrize("quant", [Quantization.I8, Quantization.F8])
def test_fused_sharded_matches_xla(rng, quant):
    """The fused Pallas local scan under shard_map (the headline serving
    config) must agree with the XLA sharded scan up to bin collisions."""
    from coltt_tpu.ops.topk import compute_recall

    n, d = 16384, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((16, d)).astype(np.float32)

    mesh = make_mesh()
    idx = DistributedFlatIndex(
        mesh, vecs, quantization=quant, rerank_dtype=jnp.float32,
    )
    _, ids_xla = idx.search(qs, k=10, oversample=8)
    _, ids_fused = idx.search(qs, k=10, oversample=8, fused=True)
    assert compute_recall(ids_fused, ids_xla) >= 0.9


def test_shard_map_single_device_not_bypassed(data):
    """bypass_single=False must run the REAL shard_map path on a 1-device
    mesh and agree exactly with the bypass path (the fused kernel x
    shard_map interaction has to be checkable on one device)."""
    import jax

    from coltt_tpu.parallel.dist_search import sharded_scan_topk

    vecs, qs = data
    mesh = make_mesh(1, devices=jax.devices()[:1])
    codes = jnp.asarray(vecs)
    scale = jnp.ones((vecs.shape[0], 1), jnp.float32)
    sqnorm = jnp.sum(codes * codes, axis=1)
    valid = jnp.ones(vecs.shape[0], bool)
    for fused in (False, True):  # fused falls back to XLA on CPU — the
        # selection logic itself must not change results
        s_direct, i_direct = sharded_scan_topk(
            mesh, codes, scale, sqnorm, valid, jnp.asarray(qs),
            k=10, metric=Metric.COSINE, compute_dtype=jnp.float32,
            fused=fused,
        )
        s_sm, i_sm = sharded_scan_topk(
            mesh, codes, scale, sqnorm, valid, jnp.asarray(qs),
            k=10, metric=Metric.COSINE, compute_dtype=jnp.float32,
            fused=fused, bypass_single=False,
        )
        np.testing.assert_array_equal(np.asarray(i_direct), np.asarray(i_sm))
        np.testing.assert_allclose(
            np.asarray(s_direct), np.asarray(s_sm), rtol=1e-6
        )


def test_multihost_mesh_and_assembly(data):
    """Single-process degradation of the multi-host layer: host-major mesh,
    full row range, device_put assembly; search results match the
    1D-mesh path exactly."""
    from coltt_tpu.parallel.multihost import (
        assemble_global_rows, host_row_range, init_distributed,
        make_multihost_mesh,
    )

    vecs, qs = data
    assert init_distributed() == 1  # no-op single process
    mesh = make_multihost_mesh()
    assert mesh.shape["shard"] == 8 and mesh.shape["batch"] == 1
    start, end = host_row_range(4096, mesh)
    assert (start, end) == (0, 4096)

    garr = assemble_global_rows(mesh, vecs, 4096)
    assert garr.shape == (4096, 64)

    codes, scale = garr, None
    sqn = jnp.sum(garr * garr, axis=1)
    valid = jnp.ones(4096, bool)
    s, i = sharded_scan_topk(mesh, codes, scale, sqn, valid,
                             jnp.asarray(qs), k=5,
                             compute_dtype=jnp.float32)
    s_ref, i_ref = scan_topk(jnp.asarray(qs), garr, None, sqn, valid, k=5,
                             compute_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))


def test_multihost_mesh_batch_axis():
    from coltt_tpu.parallel.multihost import make_multihost_mesh

    mesh = make_multihost_mesh(batch=2)
    assert mesh.shape["shard"] == 4 and mesh.shape["batch"] == 2
    with pytest.raises(ValueError):
        make_multihost_mesh(batch=3)


def test_host_row_range_divisibility():
    from coltt_tpu.parallel.multihost import make_multihost_mesh, host_row_range

    mesh = make_multihost_mesh()
    with pytest.raises(ValueError):
        host_row_range(100, mesh)  # not divisible by 8


def test_assemble_rejects_partial_rows_single_process(data):
    from coltt_tpu.parallel.multihost import (
        assemble_global_rows, make_multihost_mesh,
    )

    vecs, _ = data
    mesh = make_multihost_mesh()
    with pytest.raises(ValueError):
        assemble_global_rows(mesh, vecs[:100], 4096)


def test_bq_sharded_no_rerank_equals_global_hamming(rng):
    """BQ sharded scan, no rerank copy: each shard's exact Hamming top-k
    merged collectively must equal the global Hamming top-k (distances are
    small ints, so ties abound — compare the distance multiset, not ids)."""
    from coltt_tpu.ops.bq import bq_encode, hamming_to_neg_cos_dist
    from coltt_tpu.ops.score import normalize_score
    import jax.numpy as jnp

    n, d, k = 8192, 128, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((6, d)).astype(np.float32)

    idx = DistributedFlatIndex(make_mesh(), vecs,
                               quantization=Quantization.BQ)
    assert idx.codes.dtype == np.uint32 and idx.codes.shape[1] == d // 32
    scores, ids = idx.search(qs, k=k)

    # numpy global Hamming ground truth -> same 0-100 angle-estimate scale
    qb, cb = qs > 0, vecs > 0
    h = (qb[:, None, :] != cb[None, :, :]).sum(-1)  # [Q, N]
    want_h = np.sort(h, axis=1)[:, :k]
    negd = hamming_to_neg_cos_dist(jnp.asarray(-want_h, jnp.float32), d)
    want_scores = np.asarray(normalize_score(-negd, Metric.COSINE))
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-4)
    got_h = h[np.arange(len(qs))[:, None], ids]
    np.testing.assert_array_equal(np.sort(got_h, axis=1), want_h)


def test_bq_sharded_rerank_recall(rng):
    """BQ + per-shard rerank on the 8-device mesh: serving-grade recall on
    a clustered corpus, descending scores, no padding rows (n chosen so
    every shard carries mostly padding)."""
    from coltt_tpu.ops.topk import compute_recall

    n, d, k = 20000, 256, 10  # pads to 32768 -> 4096/shard, 2464 pad rows
    nc = 64
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, nc, n)]
            + 0.25 * rng.standard_normal((n, d))).astype(np.float32)
    qs = vecs[rng.integers(0, n, 16)] + 0.05 * rng.standard_normal(
        (16, d)).astype(np.float32)

    sim = (qs @ vecs.T) / np.linalg.norm(vecs, axis=1)
    truth = np.argsort(-sim, axis=1)[:, :k]

    idx = DistributedFlatIndex(make_mesh(), vecs,
                               quantization=Quantization.BQ,
                               rerank_dtype=jnp.bfloat16)
    scores, ids = idx.search(qs, k=k, oversample=16)
    rec = compute_recall(ids, truth)
    assert rec >= 0.9, rec
    finite = np.isfinite(scores)
    assert ((ids >= 0) & (ids < n))[finite].all()
    assert (scores[:, :-1] >= scores[:, 1:] - 1e-4).all()
