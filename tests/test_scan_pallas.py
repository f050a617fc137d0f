"""Fused Pallas scan+top-k vs the exact XLA scan (interpret mode on CPU).

The kernel keeps one candidate per bin of BIN_ROWS contiguous rows, so on
planted data (each true hit in a distinct bin) it must match the exact scan
exactly; on random data it may drop a colliding hit, which the overlap
bound checks. The same kernel compiles through Triton on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from coltt_tpu.ops.distance import Metric
from coltt_tpu.ops.quant import Quantization, dequantize, quantize
from coltt_tpu.ops import scan_pallas
from coltt_tpu.ops.scan_pallas import (
    BIN_ROWS, ROW_TILE, fused_scan_neg_topk, fused_scan_topk, supports,
)
from coltt_tpu.ops.topk import scan_topk

N, D, K = 8192, 128, 5


def _store(rng, n=N, d=D):
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    codes, scale = quantize(jnp.asarray(vecs), Quantization.F8)
    deq = dequantize(codes, scale)
    sqnorm = jnp.sum(deq * deq, axis=1)
    return vecs, codes, scale, sqnorm


def test_supports():
    assert supports(8192, 768, Metric.COSINE, jnp.float8_e4m3fn)
    assert not supports(8192, 100, Metric.COSINE, jnp.float8_e4m3fn)
    assert not supports(1000, 768, Metric.COSINE, jnp.float8_e4m3fn)
    assert supports(3 * ROW_TILE, 128, Metric.EUCLIDEAN, jnp.int8)
    assert not supports(3 * ROW_TILE + BIN_ROWS, 128, Metric.COSINE, jnp.int8)
    assert not supports(8192, 768, Metric.COSINE, jnp.float16)
    assert not supports(8192, 768, Metric.MANHATTAN, jnp.float8_e4m3fn)


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN])
def test_fused_matches_exact_on_planted(rng, metric):
    """Plant near-duplicates of the query in well-separated bins."""
    vecs, codes, scale, sqnorm = _store(rng)
    q = rng.standard_normal((3, D)).astype(np.float32)
    valid = jnp.ones((N,), bool)
    # plant K hits for query 0 in distinct bins
    planted = [17, BIN_ROWS * 5 + 3, BIN_ROWS * 20, BIN_ROWS * 40 + 99,
               BIN_ROWS * 60 + 1]
    v2 = vecs.copy()
    for j, slot in enumerate(planted):
        v2[slot] = q[0] * (1.0 + 0.01 * j)
    codes, scale = quantize(jnp.asarray(v2), Quantization.F8)
    deq = dequantize(codes, scale)
    sqnorm = jnp.sum(deq * deq, axis=1)

    s_exact, i_exact = scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K, metric=metric)
    s_fused, i_fused = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K, metric=metric)
    if metric == Metric.COSINE:
        # all planted rows are exact top-K for query 0
        assert set(np.asarray(i_fused)[0].tolist()) == set(planted)
    np.testing.assert_allclose(
        np.asarray(s_fused)[0], np.asarray(s_exact)[0], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN])
def test_fused_overlap_on_random(rng, metric):
    vecs, codes, scale, sqnorm = _store(rng)
    q = rng.standard_normal((4, D)).astype(np.float32)
    valid = jnp.ones((N,), bool)
    s_exact, i_exact = scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K, metric=metric)
    s_fused, i_fused = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K, metric=metric)
    for r in range(4):
        overlap = set(np.asarray(i_fused)[r].tolist()) & set(
            np.asarray(i_exact)[r].tolist())
        assert len(overlap) >= K - 1  # at most one bin collision plausible


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN])
def test_fused_int8_path_overlap(rng, metric):
    """int8 codes take the s8 tensor-core path (queries quantized on the
    fly)."""
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    codes, scale = quantize(jnp.asarray(vecs), Quantization.I8)
    deq = dequantize(codes, scale)
    sqnorm = jnp.sum(deq * deq, axis=1)
    q = rng.standard_normal((4, D)).astype(np.float32)
    valid = jnp.ones((N,), bool)
    s_exact, i_exact = scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K, metric=metric)
    s_fused, i_fused = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K, metric=metric)
    for r in range(4):
        overlap = set(np.asarray(i_fused)[r].tolist()) & set(
            np.asarray(i_exact)[r].tolist())
        # bin collisions + query-quantization rank flips near the boundary
        assert len(overlap) >= K - 2
    # scores agree to int8 precision on the common hits
    np.testing.assert_allclose(
        np.asarray(s_fused)[:, 0], np.asarray(s_exact)[:, 0],
        rtol=2e-2, atol=5e-1)


def test_fused_large_batch_query_blocking(rng):
    """Q > the largest query block exercises the 2D grid (query-block
    axis) and query padding (520 -> 5 blocks of 128)."""
    vecs, codes, scale, sqnorm = _store(rng, n=2048)
    q = rng.standard_normal((520, D)).astype(np.float32)
    valid = jnp.ones((2048,), bool)
    s_exact, i_exact = scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=1)
    s_fused, i_fused = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=1)
    match = (np.asarray(i_fused)[:, 0] == np.asarray(i_exact)[:, 0]).mean()
    assert match > 0.95  # top-1 is bin-collision-free by construction


def test_fused_respects_tombstones(rng):
    vecs, codes, scale, sqnorm = _store(rng)
    q = vecs[7:8]
    valid = np.ones(N, bool)
    valid[7] = False  # tombstone the self-match
    s, i = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, jnp.asarray(valid), k=3,
        metric=Metric.COSINE)
    assert 7 not in np.asarray(i)[0].tolist()


def test_fused_zero_dot_winners_keep_ids(rng):
    """Regression (ADVICE r1): bin winners with score exactly 0.0 used to
    pack to f32 *denormals* whose only set bits were the bin offset — a
    flush-to-zero copy would erase them and fabricate row ids. The packing
    biases every valid score up to ~bias magnitude (never denormal) and
    reduces in int32; ids must survive a corpus where every winner's raw
    score is exactly 0.0 (orthogonal rows) and every other row scores
    negative."""
    n, d = 2048, 128
    q = np.zeros((1, d), np.float32)
    q[0, 0] = 1.0
    vecs = np.zeros((n, d), np.float32)
    vecs[:, 0] = -0.5        # dot with q strictly negative
    vecs[:, 1] = 1.0
    planted = [3, BIN_ROWS + 7, 5 * BIN_ROWS + 11, 900, 2047]
    for slot in planted:
        vecs[slot, 0] = 0.0  # dot exactly 0.0 -> packed val exactly 0.0
    codes = jnp.asarray(vecs)  # f32 codes: dots stay exact
    sqnorm = jnp.sum(codes * codes, axis=1)
    valid = jnp.ones((n,), bool)
    s, i = fused_scan_topk(
        jnp.asarray(q), codes, None, sqnorm, valid, k=len(planted),
        metric=Metric.COSINE, final="exact")
    assert set(np.asarray(i)[0].tolist()) == set(planted)
    # cosine 0 -> normalized score 50 on the 0-100 scale
    np.testing.assert_allclose(np.asarray(s)[0], 50.0, atol=1e-3)


def test_fused_approx_bitcast_matches_exact(rng):
    """The final="approx" leg selects over the int32 monotone keys through
    a bitcast f32 *view* (valid keys are bit patterns of normal positive
    floats thanks to the score bias — float order == int order, all 32
    bits preserved). On CPU ApproxTopK lowers to an exact selection, so
    approx and exact must return IDENTICAL ids and scores — including
    negative raw scores (biased positive before packing) and tombstoned
    rows (penalty keys, which stay negative). Value-converting the keys
    to f32 instead of bitcasting would lose their low ~8 bits."""
    n, d = 8192, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    # make half the corpus anti-correlated so top-k includes negative
    # cosine similarities for some queries
    vecs[n // 2:] *= -1.0
    codes = jnp.asarray(vecs)
    sqnorm = jnp.sum(codes * codes, axis=1)
    valid = np.ones(n, bool)
    valid[::7] = False
    q = rng.standard_normal((9, d)).astype(np.float32)
    kwargs = dict(k=32, metric=Metric.COSINE)
    ne, ie = fused_scan_neg_topk(
        jnp.asarray(q), codes, None, sqnorm, jnp.asarray(valid),
        final="exact", **kwargs)
    na, ia = fused_scan_neg_topk(
        jnp.asarray(q), codes, None, sqnorm, jnp.asarray(valid),
        final="approx", **kwargs)
    np.testing.assert_array_equal(np.asarray(ie), np.asarray(ia))
    np.testing.assert_array_equal(np.asarray(ne), np.asarray(na))



def test_fused_all_invalid(rng):
    vecs, codes, scale, sqnorm = _store(rng)
    q = vecs[:2]
    valid = jnp.zeros((N,), bool)
    s, i = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=3, metric=Metric.COSINE)
    assert np.isneginf(np.asarray(s)).all()


def test_slot_plan_shapes():
    """A 1M-row store has capacity 2^20 (8192-row quanta, doubling):
    2^20 / BIN_ROWS = 32768 bins split into 32 aligned members of width
    1024; a capacity that is not a power of two still splits."""
    from coltt_tpu.ops.scan_pallas import _slot_plan

    assert _slot_plan((1 << 20) // BIN_ROWS) == (32, 1024)
    assert _slot_plan(31488) == (41, 768)
    s, w = _slot_plan(16384)
    assert s * w == 16384 and w % 128 == 0
    assert _slot_plan(7) is None


def test_fused_slot2_matches_exact_on_planted(rng):
    """slot2 keeps two survivors per strided slot: planted hits in
    distinct bins AND distinct slots must come back exactly."""
    vecs, codes, scale, sqnorm = _store(rng)
    q = rng.standard_normal((3, D)).astype(np.float32)
    valid = jnp.ones((N,), bool)
    planted = [17, BIN_ROWS * 5 + 3, BIN_ROWS * 20, BIN_ROWS * 40 + 99,
               BIN_ROWS * 60 + 1]
    v2 = vecs.copy()
    for j, slot in enumerate(planted):
        v2[slot] = q[0] * (1.0 + 0.01 * j)
    codes, scale = quantize(jnp.asarray(v2), Quantization.F8)
    deq = dequantize(codes, scale)
    sqnorm = jnp.sum(deq * deq, axis=1)

    s_ex, i_ex = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K,
        metric=Metric.COSINE, final="exact")
    s_s2, i_s2 = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K,
        metric=Metric.COSINE, final="slot2")
    assert set(np.asarray(i_s2)[0].tolist()) == set(planted)
    # member-tag injection perturbs values by ~2^-12 of the bias only
    np.testing.assert_allclose(
        np.asarray(s_s2)[0], np.asarray(s_ex)[0], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN])
def test_fused_slot2_overlap_on_random(rng, metric):
    """On random data slot2 may lose an item only to a double collision
    inside one slot — overwhelmingly unlikely at these sizes."""
    vecs, codes, scale, sqnorm = _store(rng)
    q = rng.standard_normal((4, D)).astype(np.float32)
    valid = jnp.ones((N,), bool)
    _, i_ex = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K, metric=metric,
        final="exact")
    _, i_s2 = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=K, metric=metric,
        final="slot2")
    for r in range(4):
        overlap = set(np.asarray(i_s2)[r].tolist()) & set(
            np.asarray(i_ex)[r].tolist())
        assert len(overlap) >= K - 1


def test_fused_slot2_tombstones_and_ids(rng):
    """Tombstoned rows must never surface through slot2 (their penalty
    keys stay hugely negative through the member-tag injection)."""
    vecs, codes, scale, sqnorm = _store(rng)
    q = vecs[7:8]
    valid = np.ones(N, bool)
    valid[7] = False
    s, i = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, jnp.asarray(valid), k=3,
        metric=Metric.COSINE, final="slot2")
    assert 7 not in np.asarray(i)[0].tolist()


def test_fused_slot2_wide_k_falls_back(rng):
    """k wider than the reduced slot2 set must fall back to exact, not
    crash or truncate."""
    vecs, codes, scale, sqnorm = _store(rng, n=2048)  # nbins = 128 -> width 4
    q = rng.standard_normal((2, D)).astype(np.float32)
    valid = jnp.ones((2048,), bool)
    s_ex, i_ex = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=64, final="exact")
    s_s2, i_s2 = fused_scan_topk(
        jnp.asarray(q), codes, scale, sqnorm, valid, k=64, final="slot2")
    np.testing.assert_array_equal(np.asarray(i_ex), np.asarray(i_s2))



def test_interpret_only_on_cpu_compiled_on_gpu():
    assert scan_pallas.interpret_for("cpu") is True
    assert scan_pallas.interpret_for("gpu") is False
    for platform in ("rocm", "metal", "neuron"):
        with pytest.raises(NotImplementedError, match=platform):
            scan_pallas.interpret_for(platform)


def test_wrapper_raises_on_unknown_platform(rng, monkeypatch):
    """The wrapper picks interpret mode from the platform at trace time and
    refuses one with no lowering instead of silently interpreting."""
    n, d = 3 * ROW_TILE, 256  # a shape no other test traces
    codes = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    sqnorm = jnp.sum(codes * codes, axis=1)
    monkeypatch.setattr(scan_pallas.jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError, match="rocm"):
        fused_scan_neg_topk(jnp.ones((2, d)), codes, None, sqnorm, None, k=3)


@pytest.mark.parametrize("q, itemsize, want", [
    (1, 1, (16, 256, 128, 3)),      # one query pads to a 16-row block
    (17, 1, (32, 256, 128, 3)),
    (64, 1, (64, 256, 128, 3)),
    (2048, 1, (128, 128, 128, 3)),  # big batches: 128 x 128 tiles
    (64, 2, (64, 256, 64, 3)),      # bf16 compute: 128-byte D steps
    (2048, 4, (128, 128, 32, 2)),   # f32 compute: fewer stages fit
])
def test_tile_choice(q, itemsize, want):
    qblock, rtile, d_tile, stages = scan_pallas._tiles(q, itemsize)
    assert (qblock, rtile, d_tile, stages) == want
    assert qblock * rtile <= scan_pallas._ACC_ELEMS
    assert rtile % BIN_ROWS == 0 and ROW_TILE % rtile == 0
    # shared memory per block stays under the 227 KB a Hopper SM offers
    assert (qblock + rtile) * d_tile * itemsize * stages <= 227 * 1024


@pytest.mark.parametrize("q", [1, 3, 17])
def test_query_padding_matches_full_batch(rng, q):
    """Padded query rows never leak into results: each small batch equals
    the matching rows of one 40-query batch. (I8 cosine: its bias and
    query quantization are per query, so results cannot depend on the
    rest of the batch.)"""
    vecs = rng.standard_normal((2048, D)).astype(np.float32)
    codes, scale = quantize(jnp.asarray(vecs), Quantization.I8)
    deq = dequantize(codes, scale)
    sqnorm = jnp.sum(deq * deq, axis=1)
    qs = rng.standard_normal((40, D)).astype(np.float32)
    valid = jnp.ones((2048,), bool)
    s_all, i_all = fused_scan_topk(
        jnp.asarray(qs), codes, scale, sqnorm, valid, k=K, final="exact")
    s_q, i_q = fused_scan_topk(
        jnp.asarray(qs[:q]), codes, scale, sqnorm, valid, k=K, final="exact")
    np.testing.assert_array_equal(np.asarray(i_q), np.asarray(i_all)[:q])
    np.testing.assert_array_equal(np.asarray(s_q), np.asarray(s_all)[:q])


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN])
def test_ids_at_bin_and_tile_edges(rng, metric):
    """Hits on the first and last row of bins and of row tiles, and on the
    store's last row, come back with their exact ids (bit-wise id
    reconstruction: bin column * BIN_ROWS + offset)."""
    n = 2048
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    q = rng.standard_normal((1, D)).astype(np.float32)
    # one hit per bin (a bin keeps one survivor): first/last rows of bins
    # and of row tiles, and the store's last row
    edges = [0, 2 * BIN_ROWS - 1, ROW_TILE - 1, ROW_TILE, 3 * ROW_TILE - 1,
             n - BIN_ROWS - 1, n - 1]
    for j, row in enumerate(edges):
        vecs[row] = q[0] * (1.0 + 0.01 * j)
    codes = jnp.asarray(vecs)
    sqnorm = jnp.sum(codes * codes, axis=1)
    _, ids = fused_scan_topk(
        jnp.asarray(q), codes, None, sqnorm, jnp.ones((n,), bool),
        k=len(edges), metric=metric, final="exact")
    if metric == Metric.COSINE:
        assert set(np.asarray(ids)[0].tolist()) == set(edges)
    else:  # euclidean: the nearest is the unscaled copy of q
        assert np.asarray(ids)[0, 0] == edges[0]


def test_f32_compute_matches_exact_scan(rng):
    """compute_dtype=float32 asks the kernel's dot for full f32 precision
    (TF32 would round the inputs); scores then match the exact f32 scan."""
    vecs, _, _, _ = _store(rng, n=2048)
    codes = jnp.asarray(vecs)
    sqnorm = jnp.sum(codes * codes, axis=1)
    q = rng.standard_normal((4, D)).astype(np.float32)
    valid = jnp.ones((2048,), bool)
    s_ex, i_ex = scan_topk(jnp.asarray(q), codes, None, sqnorm, valid, k=1,
                           compute_dtype=jnp.float32)
    s_fu, i_fu = fused_scan_topk(jnp.asarray(q), codes, None, sqnorm, valid,
                                 k=1, compute_dtype=jnp.float32,
                                 final="exact")
    np.testing.assert_array_equal(np.asarray(i_fu), np.asarray(i_ex))
    np.testing.assert_allclose(np.asarray(s_fu), np.asarray(s_ex), atol=1e-3)
