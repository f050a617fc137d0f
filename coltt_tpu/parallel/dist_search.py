"""Distributed FLAT search: sharded scan + collective top-k merge.

Reference parity: the shard-parallel scan with local PQs and merge
(edge/f16_vectorstore.go:138-170) scaled from goroutines to devices, and
the multi-node story the reference never shipped (empty ``loadbalancer/``).

Design (SURVEY.md §7 phase 8 / scaling-book recipe): corpus rows are
sharded over the mesh's "shard" axis; queries ride the "batch" axis (or are
replicated when batch=1). Under ``jax.shard_map`` each device scans only
its local rows with the same streaming scan as single-device, keeps a
local [Q, k] top-k (ranked on raw negated distance so euclidean's clipped
score cannot tie far rows), then one ``lax.all_gather`` of the tiny [Q, k]
partials over the device interconnect + a final top-k produce the global
result. The collective moves k*Q values per device — bytes, not the
corpus — so scaling is linear in shards until the merge dominates.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from coltt_tpu.ops.bq import (
    bq_encode,
    bq_scan_neg_topk,
    hamming_to_neg_cos_dist,
)
from coltt_tpu.ops.distance import Metric, scan_distances
from coltt_tpu.ops.pq import PQCodebook, pq_encode, pq_scan_neg_topk, train_pq
from coltt_tpu.ops.quant import Quantization, dequantize, quantize, storage_dtype
from coltt_tpu.ops.scan_pallas import ROW_TILE, fused_scan_neg_topk
from coltt_tpu.ops.scan_pallas import supports as fused_supports
from coltt_tpu.ops.score import normalize_score
from coltt_tpu.ops.topk import fetch_scores_ids, rerank_neg_topk, scan_neg_topk
from coltt_tpu.parallel.mesh import BATCH_AXIS, SHARD_AXIS


def _scan(queries, codes, scale, sqnorm, valid, *, k, metric, compute_dtype,
          block_rows, approx_recall, fused, final="auto"):
    """One local scan: the fused Pallas kernel (int8 tensor-core dot +
    in-register bin selection; see ops/scan_pallas.py) or the XLA
    exact/ApproxTopK path.
    Falls back to XLA when the kernel's shape rules don't hold."""
    if fused and not fused_supports(
        codes.shape[0], codes.shape[1], metric, codes.dtype
    ):
        fused = False
    if fused:
        return fused_scan_neg_topk(
            queries, codes, scale, sqnorm, valid,
            k=k, metric=metric, compute_dtype=compute_dtype, final=final,
        )
    return scan_neg_topk(
        queries, codes, scale, sqnorm, valid,
        k=k, metric=metric, compute_dtype=compute_dtype,
        block_rows=block_rows, approx_recall=approx_recall,
    )


def _local_scan_merge(codes, scale, sqnorm, valid, queries, *, k, metric,
                      compute_dtype, block_rows=None, approx_recall=None,
                      fused=False, final="auto"):
    """Per-device body under shard_map: local scan -> global merge."""
    negd, ids = _scan(
        queries, codes, scale, sqnorm, valid,
        k=k, metric=metric, compute_dtype=compute_dtype,
        block_rows=block_rows, approx_recall=approx_recall, fused=fused,
        final=final,
    )
    return _merge_partials(negd, ids, codes.shape[0], k)


def _local_scan_rerank_merge(codes, scale, sqnorm, valid, rr_codes, queries,
                             *, k, oversample, metric, compute_dtype,
                             block_rows=None, approx_recall=None,
                             fused=False, final="auto"):
    """Scan (low-bit, possibly approximate) -> local bf16 rerank of the
    top k*oversample -> collective merge. The rerank happens before the
    collective, so gathers stay local to each shard's rows."""
    shortlist = min(max(k * oversample, k), codes.shape[0])
    negd, ids = _scan(
        queries, codes, scale, sqnorm, valid,
        k=shortlist, metric=metric, compute_dtype=compute_dtype,
        block_rows=block_rows, approx_recall=approx_recall, fused=fused,
        final=final,
    )
    negd, ids = rerank_neg_topk(
        queries, negd, ids, rr_codes, None,
        k=k, metric=metric, compute_dtype=compute_dtype,
    )
    return _merge_partials(negd, ids, codes.shape[0], k)


def _local_scan_pqrr_merge(codes, scale, sqnorm, valid, pqcodes, queries,
                           centroids, coarse,
                           *, k, oversample, metric, compute_dtype,
                           block_rows=None, approx_recall=None,
                           fused=False, final="auto"):
    """PQ-cache serving body: f8-cache scan shortlists k*oversample, then a
    shard-LOCAL exact-PQ-reconstruction rerank (ops/pq.py
    pq_rerank_neg_topk — the gather stays on this shard's code rows), then
    the collective merge. This is FlatStore's pq_cache+oversample path
    under a mesh (VERDICT r4 #1: the engines' PQ collections must serve
    multi-device without losing the rerank's recall)."""
    shortlist = min(max(k * oversample, k), codes.shape[0])
    negd, ids = _scan(
        queries, codes, scale, sqnorm, valid,
        k=shortlist, metric=metric, compute_dtype=compute_dtype,
        block_rows=block_rows, approx_recall=approx_recall, fused=fused,
        final=final,
    )
    from coltt_tpu.ops.pq import pq_rerank_neg_topk
    negd, ids = pq_rerank_neg_topk(
        queries, negd, ids, pqcodes, centroids,
        k=min(k, negd.shape[1]), metric=metric, coarse=coarse,
    )
    return _merge_partials(negd, ids, codes.shape[0], k)


@partial(
    jax.jit,
    static_argnames=("mesh", "k", "metric", "compute_dtype", "block_rows",
                     "approx_recall", "oversample", "fused", "final",
                     "bypass_single"),
)
def sharded_scan_topk(
    mesh: Mesh,
    codes,
    scale,
    sqnorm,
    valid,
    queries,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
    block_rows=None,
    approx_recall=None,
    rr_codes=None,
    oversample: int = 8,
    fused: bool = False,
    final: str = "auto",
    pq_rerank=None,  # (pqcodes P(shard), centroids repl, coarse repl|None)
    bypass_single: bool = True,  # False: run shard_map even on 1 device
    # (equivalence checks of the fused-kernel x shard_map interaction on
    # a one-device mesh)
) -> Tuple[jax.Array, jax.Array]:
    """Global top-k over a row-sharded corpus.

    codes/scale/sqnorm/valid are sharded P(shard); queries are sharded
    P(batch) over the query axis (replicated when the batch axis is 1).
    ``rr_codes`` (sharded like codes) enables the bf16 rerank stage: the
    low-bit scan shortlists k*oversample per shard, the shortlist is
    re-scored against rr_codes, and only then do partials merge.
    ``pq_rerank`` (mutually exclusive with rr_codes) enables the PQ-cache
    serving shape instead: shortlist from the f8 cache, shard-local
    exact-PQ-reconstruction rerank, merge.
    ``fused=True`` runs each local scan through the Pallas fused kernel
    (ops/scan_pallas.py — int8 tensor-core dot, in-register bin
    selection). Returns (scores [Q, k] on the 0-100 scale, global ids
    [Q, k]).
    """
    metric = Metric.parse(metric)
    if pq_rerank is not None and rr_codes is not None:
        raise ValueError("pq_rerank and rr_codes are mutually exclusive")
    if mesh.size == 1 and bypass_single:
        if pq_rerank is not None:
            from coltt_tpu.ops.pq import pq_rerank_neg_topk
            pqcodes, centroids, coarse = pq_rerank
            shortlist = min(max(k * oversample, k), codes.shape[0])
            negd, ids = _scan(
                queries, codes, scale, sqnorm, valid,
                k=shortlist, metric=metric, compute_dtype=compute_dtype,
                block_rows=block_rows, approx_recall=approx_recall,
                fused=fused, final=final,
            )
            negd, ids = pq_rerank_neg_topk(
                queries, negd, ids, pqcodes, centroids,
                k=min(k, negd.shape[1]), metric=metric, coarse=coarse,
            )
            score = jnp.where(
                jnp.isinf(negd), -jnp.inf, normalize_score(-negd, metric)
            )
            return score, ids
        # single device: the collective layer is a no-op and shard_map only
        # adds dispatch overhead — scan directly
        if rr_codes is None:
            negd, ids = _scan(
                queries, codes, scale, sqnorm, valid,
                k=k, metric=metric, compute_dtype=compute_dtype,
                block_rows=block_rows, approx_recall=approx_recall,
                fused=fused, final=final,
            )
        else:
            shortlist = min(max(k * oversample, k), codes.shape[0])
            negd, ids = _scan(
                queries, codes, scale, sqnorm, valid,
                k=shortlist, metric=metric, compute_dtype=compute_dtype,
                block_rows=block_rows, approx_recall=approx_recall,
                fused=fused, final=final,
            )
            negd, ids = rerank_neg_topk(
                queries, negd, ids, rr_codes, None,
                k=k, metric=metric, compute_dtype=compute_dtype,
            )
        score = jnp.where(
            jnp.isinf(negd), -jnp.inf, normalize_score(-negd, metric)
        )
        return score, ids
    if pq_rerank is not None:
        pqcodes, centroids, coarse = pq_rerank
        body = partial(
            _local_scan_pqrr_merge,
            k=k, oversample=oversample, metric=metric,
            compute_dtype=compute_dtype, block_rows=block_rows,
            approx_recall=approx_recall, fused=fused, final=final,
        )
        if coarse is None:
            fn = jax.shard_map(
                lambda c, s, sq, v, pqc, q, cen: body(c, s, sq, v, pqc, q,
                                                      cen, None),
                mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                          P(SHARD_AXIS), P(SHARD_AXIS), P(BATCH_AXIS), P()),
                out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
                check_vma=False,
            )
            negd, ids = fn(codes, scale, sqnorm, valid, pqcodes, queries,
                           centroids)
        else:
            fn = jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                          P(SHARD_AXIS), P(SHARD_AXIS), P(BATCH_AXIS), P(),
                          P()),
                out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
                check_vma=False,
            )
            negd, ids = fn(codes, scale, sqnorm, valid, pqcodes, queries,
                           centroids, coarse)
    elif rr_codes is None:
        fn = jax.shard_map(
            partial(
                _local_scan_merge,
                k=k, metric=metric, compute_dtype=compute_dtype,
                block_rows=block_rows, approx_recall=approx_recall,
                fused=fused, final=final,
            ),
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                      P(SHARD_AXIS), P(BATCH_AXIS)),
            out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
            check_vma=False,
        )
        negd, ids = fn(codes, scale, sqnorm, valid, queries)
    else:
        fn = jax.shard_map(
            partial(
                _local_scan_rerank_merge,
                k=k, oversample=oversample, metric=metric,
                compute_dtype=compute_dtype,
                block_rows=block_rows, approx_recall=approx_recall,
                fused=fused, final=final,
            ),
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                      P(SHARD_AXIS), P(SHARD_AXIS), P(BATCH_AXIS)),
            out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
            check_vma=False,
        )
        negd, ids = fn(codes, scale, sqnorm, valid, rr_codes, queries)
    score = jnp.where(jnp.isinf(negd), -jnp.inf, normalize_score(-negd, metric))
    return score, ids


def _local_bq_shortlist(codes, valid, rr_codes, qpacked, queries, *,
                        k, oversample, dim):
    """Per-shard BQ search: Hamming shortlist over the packed sign bits,
    then (when ``rr_codes`` is present) a local rerank against the
    high-precision copy so the merge key is the true negated cosine
    distance; without a rerank copy the merge key is the random-hyperplane
    angle estimate (comparable across shards — same dim everywhere)."""
    shortlist = min(max(k * oversample, k), codes.shape[0])
    # no rerank copy -> the Hamming values are the final ranking: force
    # exact per-block selection (see bq_scan_neg_topk approximation note)
    negh, ids = bq_scan_neg_topk(qpacked, codes, valid, k=shortlist,
                                 exact=rr_codes is None)
    if rr_codes is not None:
        negd, ids = rerank_neg_topk(
            queries, negh, ids, rr_codes, None,
            k=min(k, negh.shape[1]), metric=Metric.COSINE,
            compute_dtype=jnp.bfloat16,
        )
    else:
        kk = min(k, negh.shape[1])
        negd, ids = hamming_to_neg_cos_dist(negh[:, :kk], dim), ids[:, :kk]
    return negd, ids


def _local_bq_merge(codes, valid, rr_codes, qpacked, queries, *,
                    k, oversample, dim):
    negd, ids = _local_bq_shortlist(
        codes, valid, rr_codes, qpacked, queries,
        k=k, oversample=oversample, dim=dim,
    )
    return _merge_partials(negd, ids, codes.shape[0], k)


@partial(jax.jit, static_argnames=("mesh", "k", "oversample", "dim"))
def sharded_bq_topk(
    mesh: Mesh,
    codes,       # [N, W] uint32 packed sign bits, sharded P(shard)
    valid,       # [N] bool, sharded P(shard)
    rr_codes,    # [N, D] rerank copy sharded P(shard), or None
    queries,     # [Q, D] f32, sharded P(batch)
    *,
    k: int,
    oversample: int = 8,
    dim: int,
) -> Tuple[jax.Array, jax.Array]:
    """Global cosine top-k over row-sharded binary (BQ) codes.

    The packed corpus is 32x smaller than f32 — a 10M x 768d corpus is
    just 960 MB of uint32 words, so the XOR+popcount scan is compute-bound,
    not HBM-bound. Queries are sign-packed once up front (replicated work
    is [Q, W] — bytes); each shard shortlists k*oversample by Hamming,
    reranks locally against ``rr_codes`` (gathers stay shard-local), and
    one [Q, k] collective merges. Returns (scores [Q, k] 0-100, ids).

    Reference anchor: the reserved ``Quantization_BQ`` enum
    (/root/reference/idl/proto/v3/core.proto) + the popcount machinery it
    never wired up (/root/reference/pkg/bitset/popcnt_amd64.s).
    """
    queries = jnp.asarray(queries, jnp.float32)
    qpacked = bq_encode(queries)
    if mesh.size == 1:
        negd, ids = _local_bq_shortlist(
            codes, valid, rr_codes, qpacked, queries,
            k=k, oversample=oversample, dim=dim,
        )
    else:
        if rr_codes is None:
            # rr_codes=None can't ride an in_spec; use the no-rr body
            fn = jax.shard_map(
                partial(_bq_merge_no_rr, k=k, oversample=oversample, dim=dim),
                mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(BATCH_AXIS),
                          P(BATCH_AXIS)),
                out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
                check_vma=False,
            )
            negd, ids = fn(codes, valid, qpacked, queries)
        else:
            fn = jax.shard_map(
                partial(_local_bq_merge, k=k, oversample=oversample, dim=dim),
                mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                          P(BATCH_AXIS), P(BATCH_AXIS)),
                out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
                check_vma=False,
            )
            negd, ids = fn(codes, valid, rr_codes, qpacked, queries)
    score = jnp.where(jnp.isinf(negd), -jnp.inf,
                      normalize_score(-negd, Metric.COSINE))
    return score, ids


def _bq_merge_no_rr(codes, valid, qpacked, queries, *, k, oversample, dim):
    return _local_bq_merge(codes, valid, None, qpacked, queries,
                           k=k, oversample=oversample, dim=dim)


def _merge_partials(negd, ids, local_n, k):
    """Shared collective tail: localize ids -> all_gather -> final top-k."""
    shard_idx = lax.axis_index(SHARD_AXIS)
    ids = ids + shard_idx * local_n
    all_negd = lax.all_gather(negd, SHARD_AXIS, axis=1, tiled=True)
    all_ids = lax.all_gather(ids, SHARD_AXIS, axis=1, tiled=True)
    kk = min(k, all_negd.shape[1])
    mneg, sel = lax.top_k(all_negd, kk)
    return mneg, jnp.take_along_axis(all_ids, sel, axis=1)


def _local_pq_scan_merge(codes, centroids, sqnorm, valid, queries, *,
                         k, metric, compute_dtype, coarse=None):
    """Per-device PQ ADC scan -> collective top-k merge (BASELINE config #4:
    PQ codebook search with continuous query batching, sharded). Queries
    arrive pre-rotated (OPQ) — the wrapper rotates once, not per shard.
    ``coarse`` (replicated) enables residual-PQ codes (2-byte cid prefix,
    ops/pq.py module doc)."""
    negd, ids = pq_scan_neg_topk(
        queries, codes, centroids, sqnorm, valid,
        k=k, metric=metric, compute_dtype=compute_dtype, coarse=coarse,
    )
    return _merge_partials(negd, ids, codes.shape[0], k)


@partial(jax.jit, static_argnames=("mesh", "k", "metric", "compute_dtype"))
def sharded_pq_topk(
    mesh: Mesh,
    codes,
    centroids,
    sqnorm,
    valid,
    queries,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
    rotation=None,
    coarse=None,
) -> Tuple[jax.Array, jax.Array]:
    """Global top-k over row-sharded PQ codes; codebook is replicated.

    ``rotation`` (replicated OPQ matrix) is applied to queries up front;
    ``coarse`` (replicated) enables residual-PQ codes.
    Returns (scores [Q, k] on the 0-100 scale, global ids [Q, k]).
    """
    metric = Metric.parse(metric)
    if rotation is not None:
        queries = jnp.matmul(jnp.asarray(queries, jnp.float32), rotation,
                             precision=lax.Precision.HIGHEST)
    if mesh.size == 1:
        negd, ids = pq_scan_neg_topk(
            queries, codes, centroids, sqnorm, valid,
            k=k, metric=metric, compute_dtype=compute_dtype, coarse=coarse,
        )
    elif coarse is None:
        fn = jax.shard_map(
            partial(
                _local_pq_scan_merge,
                k=k, metric=metric, compute_dtype=compute_dtype,
            ),
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(), P(SHARD_AXIS), P(SHARD_AXIS),
                      P(BATCH_AXIS)),
            out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
            check_vma=False,
        )
        negd, ids = fn(codes, centroids, sqnorm, valid, queries)
    else:
        fn = jax.shard_map(
            lambda c, cen, sq, v, q, co: _local_pq_scan_merge(
                c, cen, sq, v, q, k=k, metric=metric,
                compute_dtype=compute_dtype, coarse=co,
            ),
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(), P(SHARD_AXIS), P(SHARD_AXIS),
                      P(BATCH_AXIS), P()),
            out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
            check_vma=False,
        )
        negd, ids = fn(codes, centroids, sqnorm, valid, queries, coarse)
    score = jnp.where(jnp.isinf(negd), -jnp.inf, normalize_score(-negd, metric))
    return score, ids


def _cflat_scores(field_state, queries, ratios, valid, *, metric, compute_dtype):
    """Batched CFLAT scoring: Σ_f ratio_f * normalize(dist_f) -> [Q, N]."""
    total = None
    for (codes, scale, sqnorm), q, r in zip(field_state, queries, ratios):
        dist = scan_distances(
            q, codes, scale, sqnorm, None,
            metric=metric, compute_dtype=compute_dtype,
        )  # [Q, N]
        contrib = normalize_score(dist, metric) * r
        total = contrib if total is None else total + contrib
    return jnp.where(valid.reshape(1, -1), total, -jnp.inf)


def _local_cflat_merge(codes_scale_sqn, valid, queries, ratios, *,
                       k, metric, compute_dtype):
    total = _cflat_scores(
        codes_scale_sqn, queries, ratios, valid,
        metric=metric, compute_dtype=compute_dtype,
    )
    kk = min(k, total.shape[1])
    vals, ids = lax.top_k(total, kk)
    return _merge_partials(vals, ids.astype(jnp.int32), valid.shape[0], k)


@partial(jax.jit, static_argnames=("mesh", "k", "metric", "compute_dtype"))
def sharded_cflat_topk(
    mesh: Mesh,
    field_state,   # tuple of (codes [N,Df], scale [N,1]|None, sqnorm [N])
    valid,
    queries,       # tuple of [Q, Df] f32, parallel to field_state
    ratios,        # tuple of scalar f32 (already /100)
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
) -> Tuple[jax.Array, jax.Array]:
    """CFLAT weighted multi-vector search over a row-sharded corpus
    (BASELINE config #5): every field's scan is local to the shard; the
    weighted score sum ranks locally and one tiny collective merges.
    Returns (scores [Q, k], global ids [Q, k]); scores are already the
    0-100 weighted sums (ranking key == reference's, multi_vector_vertex.go
    :113-121)."""
    metric = Metric.parse(metric)
    if mesh.size == 1:
        total = _cflat_scores(
            field_state, queries, ratios, valid,
            metric=metric, compute_dtype=compute_dtype,
        )
        kk = min(k, total.shape[1])
        return lax.top_k(total, kk)
    nf = len(field_state)
    fn = jax.shard_map(
        partial(
            _local_cflat_merge,
            k=k, metric=metric, compute_dtype=compute_dtype,
        ),
        mesh=mesh,
        in_specs=(
            tuple(
                (P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS))
                for _ in range(nf)
            ),
            P(SHARD_AXIS),
            tuple(P(BATCH_AXIS) for _ in range(nf)),
            tuple(P() for _ in range(nf)),
        ),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        check_vma=False,
    )
    return fn(field_state, valid, queries, ratios)


class DistributedPQIndex:
    """Row-sharded PQ index: train once (sampled), encode + shard, serve
    ADC scans with collective merge. PQ codes at M=dim/8 are ~1 byte per 8
    floats — what lets a 10M x 768d corpus fit a single chip's HBM
    (BASELINE config #4)."""

    def __init__(
        self,
        mesh: Mesh,
        vectors,
        *,
        metric: Metric = Metric.COSINE,
        codebook: Optional[PQCodebook] = None,
        m: Optional[int] = None,
        train_sample: int = 65_536,
        compute_dtype=jnp.bfloat16,
        opq_iters: int = 0,
    ):
        self.mesh = mesh
        self.metric = Metric.parse(metric)
        self.compute_dtype = compute_dtype
        vectors = jnp.asarray(vectors, jnp.float32)
        n, dim = vectors.shape
        self.n, self.dim = n, dim
        if codebook is None:
            codebook = train_pq(vectors, m=m, sample_size=train_sample,
                                opq_iters=opq_iters)
        self.codebook = codebook

        n_shards = mesh.shape[SHARD_AXIS]
        pad = (-n) % n_shards
        if pad:
            vectors = jnp.concatenate(
                [vectors, jnp.zeros((pad, dim), jnp.float32)], axis=0
            )
        codes, sqnorm = pq_encode(vectors, codebook)
        valid = jnp.arange(vectors.shape[0]) < n

        spec = NamedSharding(mesh, P(SHARD_AXIS))
        self.codes = jax.device_put(codes, spec)
        self.sqnorm = jax.device_put(sqnorm, spec)
        self.valid = jax.device_put(valid, spec)
        self.centroids = jax.device_put(
            codebook.centroids, NamedSharding(mesh, P())
        )
        self.rotation = (
            jax.device_put(codebook.rotation, NamedSharding(mesh, P()))
            if codebook.rotation is not None else None
        )

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        batch = self.mesh.shape[BATCH_AXIS]
        q = queries.shape[0]
        pad = (-q) % batch
        if pad:
            queries = np.concatenate(
                [queries, np.zeros((pad, self.dim), np.float32)], axis=0
            )
        qspec = NamedSharding(self.mesh, P(BATCH_AXIS))
        jq = jax.device_put(jnp.asarray(queries), qspec)
        scores, ids = sharded_pq_topk(
            self.mesh, self.codes, self.centroids, self.sqnorm, self.valid,
            jq, k=k, metric=self.metric, compute_dtype=self.compute_dtype,
            rotation=self.rotation,
        )
        scores, ids = fetch_scores_ids(scores, ids)
        scores, ids = scores[:q], ids[:q]
        ids = np.where(np.isneginf(scores), -1, ids)
        return scores, ids


class DistributedFlatIndex:
    """A row-sharded immutable FLAT index for serving benchmarks and the
    multi-chip path. Ingest quantizes + shards once (device_put with a
    NamedSharding lays rows out round-robin contiguously per shard); search
    runs the collective scan above. Mutable serving uses FlatStore with a
    sharded placement; this class is the zero-copy bulk path."""

    def __init__(
        self,
        mesh: Mesh,
        vectors: np.ndarray,
        *,
        metric: Metric = Metric.COSINE,
        quantization: Quantization = Quantization.NONE,
        compute_dtype=None,
        rerank_dtype=None,  # e.g. jnp.bfloat16: keep a high-precision copy
    ):
        self.mesh = mesh
        self.metric = Metric.parse(metric)
        self.quantization = Quantization.parse(quantization)
        self.rerank_dtype = rerank_dtype
        if compute_dtype is None:
            compute_dtype = (
                jnp.float32 if self.quantization == Quantization.NONE
                else jnp.bfloat16
            )
        self.compute_dtype = compute_dtype

        n_shards = mesh.shape[SHARD_AXIS]
        n, dim = vectors.shape
        vectors = jnp.asarray(vectors, jnp.float32)  # host or device input
        # pad so every shard's local row count is a multiple of the fused
        # kernel's row tile (ops/scan_pallas.py shape rule); padding rows
        # are masked invalid and can never be returned
        pad = (-n) % (n_shards * ROW_TILE)
        if pad:
            vectors = jnp.concatenate(
                [vectors, jnp.zeros((pad, dim), jnp.float32)], axis=0
            )
        self.n = n
        self.dim = dim
        np_total = vectors.shape[0]
        valid = jnp.arange(np_total) < n

        spec = NamedSharding(mesh, P(SHARD_AXIS))
        if self.quantization == Quantization.BQ:
            if self.metric != Metric.COSINE:
                raise ValueError("BQ is cosine-only")
            # 1-bit sign codes: [N, ceil(D/32)] uint32, 32x under f32.
            # Padding rows are all-zero words masked by `valid`.
            self.codes = jax.device_put(bq_encode(vectors), spec)
            self.scale = None
            self.sqnorm = None
        else:
            codes, scale = quantize(vectors, self.quantization)
            codes = codes.astype(storage_dtype(self.quantization))
            deq = dequantize(codes, scale)
            sqnorm = jnp.sum(deq * deq, axis=1)
            self.codes = jax.device_put(codes, spec)
            self.scale = jax.device_put(scale, spec)
            self.sqnorm = jax.device_put(sqnorm, spec)
        self.valid = jax.device_put(valid, spec)
        self.rr_codes = (
            jax.device_put(vectors.astype(rerank_dtype), spec)
            if rerank_dtype is not None else None
        )

    @classmethod
    def from_bq_codes(
        cls,
        mesh: Mesh,
        packed: np.ndarray,   # [N, ceil(dim/32)] uint32 sign bits
        *,
        dim: int,
        rr_codes: Optional[np.ndarray] = None,  # [N, dim] rerank copy
        rerank_dtype=jnp.bfloat16,
    ) -> "DistributedFlatIndex":
        """Build a BQ index from pre-packed sign codes — the streaming
        ingest path for corpora whose f32 form exceeds HBM (e.g. 10M x 768d
        = 30 GB f32 vs 960 MB packed): callers encode slab-wise with
        ``bq_encode`` and hand the packed rows here."""
        self = cls.__new__(cls)
        self.mesh = mesh
        self.metric = Metric.COSINE
        self.quantization = Quantization.BQ
        self.rerank_dtype = rerank_dtype if rr_codes is not None else None
        self.compute_dtype = jnp.bfloat16
        n, w = packed.shape
        self.n, self.dim = n, dim
        n_shards = mesh.shape[SHARD_AXIS]
        pad = (-n) % (n_shards * ROW_TILE)
        if pad:
            packed = np.concatenate(
                [packed, np.zeros((pad, w), packed.dtype)]
            )
        valid = np.arange(n + pad) < n
        spec = NamedSharding(mesh, P(SHARD_AXIS))
        self.codes = jax.device_put(jnp.asarray(packed), spec)
        self.valid = jax.device_put(jnp.asarray(valid), spec)
        if rr_codes is not None:
            rr = np.asarray(rr_codes)
            if pad:
                rr = np.concatenate([rr, np.zeros((pad, dim), rr.dtype)])
            self.rr_codes = jax.device_put(
                jnp.asarray(rr).astype(rerank_dtype), spec
            )
        else:
            self.rr_codes = None
        return self

    def search(
        self, queries: np.ndarray, k: int, *, approx_recall=None,
        oversample: int = 8, fused: bool = False, final: str = "auto",
    ) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        batch = self.mesh.shape[BATCH_AXIS]
        q = queries.shape[0]
        pad = (-q) % batch
        if pad:
            queries = np.concatenate(
                [queries, np.zeros((pad, self.dim), np.float32)], axis=0
            )
        qspec = NamedSharding(self.mesh, P(BATCH_AXIS))
        jq = jax.device_put(jnp.asarray(queries), qspec)
        if self.quantization == Quantization.BQ:
            scores, ids = sharded_bq_topk(
                self.mesh, self.codes, self.valid, self.rr_codes, jq,
                k=k, oversample=oversample, dim=self.dim,
            )
        else:
            scores, ids = sharded_scan_topk(
                self.mesh, self.codes, self.scale, self.sqnorm, self.valid, jq,
                k=k, metric=self.metric, compute_dtype=self.compute_dtype,
                approx_recall=approx_recall,
                rr_codes=self.rr_codes, oversample=oversample, fused=fused,
                final=final,
            )
        scores, ids = fetch_scores_ids(scores, ids)
        scores, ids = scores[:q], ids[:q]
        ids = np.where(np.isneginf(scores), -1, ids)
        return scores, ids
