"""Streaming scan + top-k.

Reference parity: the edge FLAT scan with bounded top-K heaps —
``edge/f16_vectorstore.go:131-187`` (per-shard goroutines each with a local
PQ, then merge) and ``edge/priority_queue.go:33-75``.

Design: the goroutine-shard map-reduce becomes a two-stage
top-k. The row axis is processed in fixed-size blocks under ``lax.map``
(bounding the [Q, N] score materialization to [Q, block]); each block
produces its local top-k on the scan output, and a final ``lax.top_k``
merges the [Q, blocks*k] partials. Exactly the reference's
local-heap-then-merge shape, but each "shard" is a device-sized tile instead
of a goroutine, and "merge" is one more top-k instead of a heap drain.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from coltt_tpu.ops.distance import Metric, scan_distances
from coltt_tpu.ops.score import normalize_score

# Default rows per block: keeps the [Q, block] f32 scores + the [block, D]
# code tile a bounded working set while keeping the matrix units busy.
DEFAULT_BLOCK_ROWS = 131_072

# Per-block transient budget (scores + dequant copies) before the scan
# switches to blocked mode. One big fused matmul + top_k beats
# lax.map-serialized blocks (the map body runs its blocks one after
# another); block only to bound device memory. 1 GB: lax.map
# double-buffers the block transients, and this budget was sized for a
# 16 GB device holding a 10M-row store (ROADMAP D3 re-derives it).
SCORES_BYTES_BUDGET = 1 << 30

_ALIGN = 8192  # stores grow capacity in these quanta


def _block_count(n: int, block, q: int, row_bytes: int = 0) -> int:
    """Blocks to split the row axis into. ``block=None`` = auto by memory.

    ``row_bytes`` charges per-row transients BEYOND the [Q, block] score
    tile — chiefly the dequantized compute_dtype copy of the code block.
    Without it, a small-Q search over a big store went single-block and
    materialized the WHOLE corpus in compute dtype (15 GB at 10M x 768d
    bf16 — measured OOM on a Q=4 search against a loaded 10M PQ cache)."""
    if block is None:
        per_row = q * 4 + row_bytes
        if per_row * n <= SCORES_BYTES_BUDGET or n % _ALIGN != 0:
            return 1
        need = -(-(per_row * n) // SCORES_BYTES_BUDGET)
        units = n // _ALIGN
        blocks = need
        while blocks <= units and units % blocks != 0:
            blocks += 1
        return blocks if blocks <= units else 1
    if n <= block or n % block != 0:
        return 1
    return n // block


def _select_topk(neg, k, approx_recall):
    """Exact or ApproxTopK selection over negated distances [Q, N]."""
    if approx_recall is None or neg.shape[1] <= k:
        return lax.top_k(neg, k)
    vals, idx = lax.approx_max_k(neg, k, recall_target=float(approx_recall))
    return vals, idx


def scan_neg_topk(
    queries,
    codes,
    scale,
    sqnorm,
    valid,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
    block_rows=None,
    approx_recall=None,
):
    """Top-k scan returning raw ranking values ``(negdist [Q,k], ids [Q,k])``.

    Ranks on raw (negated) distance, not the 0-100 score: the euclidean
    score clips at 0 (max(0, 100-d)) which would tie all far rows. The
    reference likewise keeps distances in its heaps and normalizes per
    returned hit only (edge/edge.go:661-681). This raw form is also the
    merge key for multi-device partials.

    ``approx_recall`` switches the selection to XLA's ApproxTopK
    (the bin-reduction of arXiv:2206.14286) with that per-element recall
    target; on GPU and CPU, XLA lowers it to an exact top-k. The selection
    is over post-quantization distances — end-to-end recall vs fp32 is
    dominated by the storage quantization, not this knob.
    """
    metric = Metric.parse(metric)
    queries = jnp.asarray(queries, jnp.float32)
    n = codes.shape[0]
    # charge the dequant copy only when the codes aren't already in
    # compute dtype (then scan_distances materializes a [block, D] copy);
    # x2 for lax.map double-buffering
    row_bytes = (
        0 if codes.dtype == compute_dtype
        else 2 * codes.shape[1] * jnp.dtype(compute_dtype).itemsize
    )
    blocks = _block_count(n, block_rows, queries.shape[0], row_bytes)
    kk = min(k, n)

    if blocks == 1:
        dist = scan_distances(
            queries, codes, scale, sqnorm, valid,
            metric=metric, compute_dtype=compute_dtype,
        )
        negd, idx = _select_topk(-dist, kk, approx_recall)
    else:
        block = n // blocks
        kb = min(kk, block)

        def body(i):
            sl = lambda a: lax.dynamic_slice_in_dim(a, i * block, block, axis=0)
            dist = scan_distances(
                queries,
                sl(codes),
                None if scale is None else sl(scale),
                None if sqnorm is None else sl(sqnorm),
                None if valid is None else sl(valid),
                metric=metric,
                compute_dtype=compute_dtype,
            )
            vals, idx = _select_topk(-dist, kb, approx_recall)
            return vals, (idx + i * block).astype(jnp.int32)

        vals, ids = lax.map(body, jnp.arange(blocks))  # [blocks, Q, kb]
        q = queries.shape[0]
        vals = jnp.moveaxis(vals, 0, 1).reshape(q, blocks * kb)
        ids = jnp.moveaxis(ids, 0, 1).reshape(q, blocks * kb)
        negd, midx = lax.top_k(vals, kk)
        idx = jnp.take_along_axis(ids, midx, axis=1)

    return negd, idx.astype(jnp.int32)


@partial(
    jax.jit,
    static_argnames=("k", "metric", "compute_dtype", "block_rows", "approx_recall"),
)
def scan_topk(
    queries,
    codes,
    scale,
    sqnorm,
    valid,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
    block_rows=None,
    approx_recall=None,
):
    """Top-k scan over the full store.

    Returns ``(scores [Q, k], ids [Q, k])`` with scores on the 0-100 scale,
    descending; tombstoned rows surface as -inf score (callers drop them).
    """
    metric = Metric.parse(metric)
    negd, idx = scan_neg_topk(
        queries, codes, scale, sqnorm, valid,
        k=k, metric=metric, compute_dtype=compute_dtype, block_rows=block_rows,
        approx_recall=approx_recall,
    )
    score = jnp.where(jnp.isinf(negd), -jnp.inf, normalize_score(-negd, metric))
    return score, idx


def rerank_neg_topk(
    queries,
    negd,
    ids,
    rr_codes,
    rr_scale,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
):
    """Re-score shortlisted candidates against a higher-precision copy.

    ``negd/ids [Q, C]`` come from a (possibly approximate, low-bit) scan;
    ``rr_codes [N, D]`` is the rerank representation (e.g. bf16 rows —
    the f8 scan's recall ceiling is storage error, measured 0.94@10 on
    1M x 768d; reranking the top C=8k candidates through bf16 restores
    ~fp32 ranking for the price of a [Q, C, D] gather). Returns
    ``(negdist [Q, k], ids [Q, k])`` on the rerank precision.
    """
    metric = Metric.parse(metric)
    queries = jnp.asarray(queries, jnp.float32)
    safe = jnp.where(ids >= 0, ids, 0)
    cand = jnp.take(rr_codes, safe, axis=0)               # [Q, C, D]
    if rr_scale is not None:
        cand = cand.astype(jnp.float32) * jnp.take(rr_scale, safe, axis=0)
    return rescore_topk(queries, cand, negd, ids, k=k, metric=metric,
                        compute_dtype=compute_dtype)


def rescore_topk(
    queries,
    cand,
    negd,
    ids,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
):
    """Rank ``cand [Q, C, D]`` candidate vectors against ``queries [Q, D]``
    and keep the top k of the shortlist (the scoring tail of
    :func:`rerank_neg_topk`, for callers that materialize candidates
    themselves — e.g. PQ reconstruction rerank)."""
    metric = Metric.parse(metric)
    queries = jnp.asarray(queries, jnp.float32)
    qc = queries.astype(compute_dtype)
    cc = cand.astype(compute_dtype)
    # f32 reranks ask for full f32 (a GPU runs f32 matmuls as TF32 by
    # default); bf16 operands are exact in either mode
    prec = lax.Precision.HIGHEST if compute_dtype == jnp.float32 else None
    dots = jnp.einsum("qd,qcd->qc", qc, cc, precision=prec,
                      preferred_element_type=jnp.float32)
    csq = jnp.einsum("qcd,qcd->qc", cc, cc, precision=prec,
                     preferred_element_type=jnp.float32)
    if metric == Metric.COSINE:
        qn = jnp.sqrt(jnp.sum(queries * queries, axis=1, keepdims=True))
        dist = 1.0 - dots / jnp.maximum(qn * jnp.sqrt(jnp.maximum(csq, 0.0)), 1e-30)
    else:
        qsq = jnp.sum(queries * queries, axis=1, keepdims=True)
        dist = jnp.maximum(qsq + csq - 2.0 * dots, 0.0)
    # keep the scan's tombstone/padding masking
    dist = jnp.where(jnp.isfinite(negd), dist, jnp.inf)
    kk = min(k, dist.shape[1])
    rneg, sel = lax.top_k(-dist, kk)
    return rneg, jnp.take_along_axis(ids, sel, axis=1)


def fetch_scores_ids(scores, ids):
    """One-round-trip device->host fetch of a (scores f32, ids int32) pair.

    Bitcasts the SCORES into int32 and concatenates with the ids, so the
    result crosses the device boundary as ONE buffer: one device-to-host
    copy instead of two. The packing must live in int32 space: the
    reverse (ids bitcast to f32) turns small ids into denormals, which a
    flush-to-zero copy would erase, and -1 into a NaN payload — int32 is
    bit-exact for both. Returns host ``(scores [Q, k] f32, ids [Q, k]
    int32)``.
    """
    packed = jnp.concatenate(
        [
            lax.bitcast_convert_type(
                jnp.asarray(scores, jnp.float32), jnp.int32
            ),
            ids.astype(jnp.int32),
        ],
        axis=1,
    )
    host = np.asarray(jax.device_get(packed))
    k = host.shape[1] // 2
    return host[:, :k].view(np.float32), host[:, k:]


@partial(jax.jit, static_argnames=("k",))
def merge_topk(scores_a, ids_a, scores_b, ids_b, *, k: int):
    """Merge two ``[Q, ka] / [Q, kb]`` top-k partials into one ``[Q, k]``.

    The collective-merge building block for multi-device search (the role of
    the reference's shard-PQ merge loop, edge/f16_vectorstore.go:160-170).
    """
    vals = jnp.concatenate([scores_a, scores_b], axis=1)
    ids = jnp.concatenate([ids_a, ids_b], axis=1)
    kk = min(k, vals.shape[1])
    mvals, midx = lax.top_k(vals, kk)
    return mvals, jnp.take_along_axis(ids, midx, axis=1)


def compute_recall(result_ids, truth_ids) -> float:
    """Fraction of ground-truth ids present in the results, averaged over
    queries (ComputeRecall parity, edge/resultset.go:54-64).

    Both arguments are ``[Q, k]`` id arrays; negative ids (empty slots)
    in the truth are ignored.
    """
    import numpy as np

    result_ids = np.asarray(result_ids)
    truth_ids = np.asarray(truth_ids)
    if result_ids.ndim == 1:
        result_ids = result_ids[None]
        truth_ids = truth_ids[None]
    total, hit = 0, 0
    for r in range(truth_ids.shape[0]):
        truth = set(int(t) for t in truth_ids[r] if t >= 0)
        if not truth:
            continue
        got = set(int(t) for t in result_ids[r])
        hit += len(truth & got)
        total += len(truth)
    return hit / total if total else 1.0
