"""Batched distance kernels.

Reference parity: ``pkg/distance`` (``space.go:40-48`` runtime AVX/SSE/go
dispatch; C++ SIMD sources ``pkg/distance/simd/cpp/{avx,sse}.cpp`` computing
euclidean_distance_squared / manhattan_distance / cosine 1 - dot/sqrt(nn)).

Design: the reference calls a SIMD kernel once per vector *pair* inside Go
loops; here a whole scan is one ``[Q, D] x [N, D] -> [Q, N]`` contraction
(a tensor-core matrix product). Cosine and (squared) euclidean both reduce to the
same dot-product matmul plus elementwise epilogue using precomputed squared
norms, so the quantized codes are read from HBM exactly once:

    cosine    d = 1 - dot / (|q| * sqrt(sqnorm))        (same as avx.cpp)
    euclidean d = |q|^2 + sqnorm - 2 * dot              (squared, like the ref)
    manhattan d = sum |q - v|   (elementwise, chunked; kernels-only in the ref)

Per-row dequant scales fold into the epilogue: dot(q, codes*scale) =
(q @ codes^T) * scale^T. Invalid (tombstoned) rows get +inf distance, the
analogue of the reference skipping deleted map entries.
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


class Metric(enum.IntEnum):
    """Matches the proto Distance enum (Cosine=0, Euclidean=1); manhattan is
    kernel-layer only in the reference too (never exposed in a proto)."""

    COSINE = 0
    EUCLIDEAN = 1
    MANHATTAN = 2

    @classmethod
    def parse(cls, v) -> "Metric":
        if isinstance(v, Metric):
            return v
        if isinstance(v, str):
            return cls[v.strip().upper()]
        return cls(int(v))


_EPS = 1e-30


def quantize_queries_i8(queries, *, per_query: bool = True):
    """Symmetric int8 query quantization: ``(codes int8, scale f32)`` with
    ``codes = round(q * (127 / max|q|))`` per query (``per_query``) or over
    the whole batch, and ``scale = max|q| / 127``.

    The codes come from ONE division per scale and a multiply per element,
    so they are bit-identical on every backend and to a numpy reference
    doing the same: XLA rewrites a division by a constant or a broadcast
    into a multiply by its reciprocal, which rounds differently."""
    qmax = jnp.max(jnp.abs(queries), axis=-1 if per_query else None,
                   keepdims=per_query)
    inv = jnp.where(qmax > 0, 127.0 / jnp.where(qmax > 0, qmax, 1.0), 1.0)
    codes = jnp.round(queries * inv).clip(-127, 127).astype(jnp.int8)
    return codes, 1.0 / inv


def _dot_scores(queries, codes, scale, compute_dtype):
    """(queries @ dequant(codes).T) with f32 accumulation: [Q, N]."""
    if codes.dtype == jnp.int8:
        # int8 tensor-core path: queries are quantized per-row symmetric
        # int8 on the fly; both scales fold into the f32 epilogue. Query
        # rounding error is ~1/254 relative — below the stored-row
        # quantization error and removed entirely by rerank.
        qi, qscale = quantize_queries_i8(queries)
        dots = lax.dot_general(
            qi,
            codes,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32) * qscale
        if scale is not None:
            dots = dots * scale.reshape(1, -1)
        return dots
    if compute_dtype == jnp.float32:
        dots = lax.dot_general(
            queries.astype(jnp.float32),
            codes.astype(jnp.float32),
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
    else:
        dots = lax.dot_general(
            queries.astype(compute_dtype),
            codes.astype(compute_dtype),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    if scale is not None:
        dots = dots * scale.reshape(1, -1)
    return dots


def _manhattan(queries, codes, scale, row_chunk: int = 2048):
    """Chunked sum|q - v| — bandwidth-bound elementwise path, no matmul
    form."""
    n = codes.shape[0]
    chunk = min(row_chunk, n)
    if n % chunk != 0:
        chunk = n  # callers keep N a multiple of the chunk; fall back whole
    blocks = n // chunk

    def body(i):
        c = lax.dynamic_slice_in_dim(codes, i * chunk, chunk, axis=0).astype(jnp.float32)
        if scale is not None:
            s = lax.dynamic_slice_in_dim(scale, i * chunk, chunk, axis=0)
            c = c * s
        # [Q, chunk, D] -> [Q, chunk]
        return jnp.sum(jnp.abs(queries[:, None, :] - c[None, :, :]), axis=-1)

    out = lax.map(body, jnp.arange(blocks))  # [blocks, Q, chunk]
    return jnp.moveaxis(out, 0, 1).reshape(queries.shape[0], n)


def scan_distances(
    queries,
    codes,
    scale=None,
    sqnorm=None,
    valid=None,
    *,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
):
    """Distances from every query to every stored row: ``[Q, N] float32``.

    queries: [Q, D] float32; codes: [N, D] storage dtype; scale: [N, 1] f32
    or None; sqnorm: [N] f32 squared norms of the *dequantized* rows (required
    for cosine/euclidean — precomputed at ingest so the scan is one matmul);
    valid: [N] bool tombstone mask (False rows get +inf).
    """
    metric = Metric.parse(metric)
    queries = jnp.asarray(queries, jnp.float32)

    if metric == Metric.MANHATTAN:
        dist = _manhattan(queries, codes, scale)
    else:
        dots = _dot_scores(queries, codes, scale, compute_dtype)
        if metric == Metric.COSINE:
            qn = jnp.sqrt(jnp.sum(queries * queries, axis=1, keepdims=True))
            vn = jnp.sqrt(jnp.maximum(sqnorm, 0.0)).reshape(1, -1)
            dist = 1.0 - dots / jnp.maximum(qn * vn, _EPS)
        else:  # squared euclidean, matching the reference SIMD kernel
            qsq = jnp.sum(queries * queries, axis=1, keepdims=True)
            dist = qsq + sqnorm.reshape(1, -1) - 2.0 * dots
            dist = jnp.maximum(dist, 0.0)

    if valid is not None:
        dist = jnp.where(valid.reshape(1, -1), dist, jnp.inf)
    return dist


@partial(jax.jit, static_argnames=("metric",))
def distance_pair(x, y, metric: Metric = Metric.COSINE):
    """Single-pair distance (CompareDist parity, core/core.go:841-867)."""
    metric = Metric.parse(metric)
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    if metric == Metric.COSINE:
        nx = jnp.sqrt(jnp.sum(x * x))
        ny = jnp.sqrt(jnp.sum(y * y))
        return 1.0 - jnp.dot(x, y, precision=lax.Precision.HIGHEST) / jnp.maximum(
            nx * ny, _EPS
        )
    if metric == Metric.EUCLIDEAN:
        d = x - y
        return jnp.dot(d, d, precision=lax.Precision.HIGHEST)
    return jnp.sum(jnp.abs(x - y))


def pairwise_distance(xs, ys, metric: Metric = Metric.COSINE):
    """[A, D] x [B, D] -> [A, B] float32 distances on raw fp32 vectors."""
    ys = jnp.asarray(ys, jnp.float32)
    sqn = jnp.sum(ys * ys, axis=1)
    return scan_distances(
        xs, ys, None, sqnorm=sqn, metric=metric, compute_dtype=jnp.float32
    )
