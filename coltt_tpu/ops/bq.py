"""Binary quantization (BQ): 1-bit sign codes, Hamming shortlist, rerank.

Reference parity: ``Quantization_BQ`` is a *reserved* enum value in the
reference protos (``idl/proto/v3/core.proto`` Quantization) that was never
implemented there; the closest shipped machinery is the vendored popcount
bitset (``pkg/bitset/popcnt_amd64.s``) and the hamming distance registered
in ``pkg/distancepq/distance.go:52-86``. This module completes the mode.

Design: each vector becomes its sign bits packed into uint32
words (``[N, ceil(D/32)]`` — 32x smaller than f32, 8x smaller than i8).
Search is a streaming XOR + ``lax.population_count`` scan (pure elementwise work;
the packed corpus is so small the scan is compute-bound, not HBM-bound),
shortlisting ``k * oversample`` rows by Hamming distance, then an optional
rerank of the gathered shortlist against a higher-precision copy (the same
``ops.topk.rerank_neg_topk`` machinery the fused i8 path uses). Hamming on
sign bits estimates the angle: ``cos(theta) ~= cos(pi * H / D)`` — exact in
expectation for random hyperplane signs — so the shortlist ranking tracks
cosine ranking, and the rerank restores the top-k ordering.

BQ is cosine-only: sign bits carry no magnitude, so euclidean/manhattan
ranking is undefined (the reference's hamming distance is likewise a
standalone metric, not a euclidean stand-in).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# [Q, block, W] popcount transient budget (pre-fusion upper bound); blocks
# bound device memory next to a loaded corpus the same way ops.topk
# blocks do (sized for a 16 GB device; ROADMAP D3 re-derives it).
_BQ_TRANSIENT_BYTES = 1 << 30
_ALIGN = 8192


def bq_words(dim: int) -> int:
    """uint32 words per packed row."""
    return -(-int(dim) // 32)


def bq_encode(x) -> jnp.ndarray:
    """Pack sign bits of ``x [..., D] f32`` into ``[..., ceil(D/32)] uint32``.

    Bit ``j`` of word ``w`` is ``x[..., 32*w + j] > 0``. Padding dims (when
    D % 32 != 0) are zero bits for every row *and* every query, so they XOR
    to zero and never contribute Hamming distance.
    """
    x = jnp.asarray(x)
    d = x.shape[-1]
    w = bq_words(d)
    pad = w * 32 - d
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    bits = (x > 0).astype(jnp.uint32).reshape(x.shape[:-1] + (w, 32))
    shifts = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(bits * shifts, axis=-1, dtype=jnp.uint32)


def _block_count(n: int, q: int, w: int) -> int:
    if q * n * w * 4 <= _BQ_TRANSIENT_BYTES or n % _ALIGN != 0:
        return 1
    need = -(-(q * n * w * 4) // _BQ_TRANSIENT_BYTES)
    units = n // _ALIGN
    if need >= units:
        # even the finest _ALIGN-row blocks exceed the budget: take them
        # anyway (NOT an unblocked scan — that reintroduces the full [Q,N,W]
        # transient this budget exists to bound) and let bq_scan_neg_topk
        # split the query axis for the remaining overage.
        return units
    blocks = need
    while units % blocks:
        blocks += 1
    return blocks


def _hamming_block(qp, cp, valid):
    """qp [Q, W], cp [B, W], valid [B] -> negated Hamming [Q, B] f32."""
    x = lax.population_count(qp[:, None, :] ^ cp[None, :, :])  # [Q, B, W]
    h = jnp.sum(x.astype(jnp.int32), axis=-1)                  # [Q, B]
    neg = -h.astype(jnp.float32)
    if valid is not None:
        neg = jnp.where(valid[None, :], neg, -jnp.inf)
    return neg


def _unpack_pm1(packed, d32: int):
    """[B, W] uint32 -> [B, W*32] int8 in {-1, +1} (bit j of word w ->
    column 32w+j, matching bq_encode's layout)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[:, :, None] >> shifts) & jnp.uint32(1)
    return (2 * bits.astype(jnp.int8) - 1).reshape(packed.shape[0], d32)


def _matmul_hamming_block(qi, cp, valid):
    """Matmul form of the Hamming scan: with rows/queries mapped to ±1,
    ``dot = W*32 - 2*hamming`` — one s8xs8->s32 contraction at the int8
    tensor-core rate instead of a popcount chain. Padding
    bits (dim % 32) decode to -1 on BOTH sides, adding the same constant
    to every dot — ranking and the recovered Hamming are exact. The
    unpacked [B, W*32] block is a bounded transient; packed codes remain
    the only persistent form, so the 32x memory win stands. This path is
    matmul-bound (~30 TOP per 2048-query batch at 10M x 768d)."""
    d32 = qi.shape[1]
    cs = _unpack_pm1(cp, d32)
    dots = lax.dot_general(
        qi, cs, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    neg = ((dots - d32) // 2).astype(jnp.float32)  # exact -hamming
    if valid is not None:
        neg = jnp.where(valid[None, :], neg, -jnp.inf)
    return neg


@partial(jax.jit, static_argnames=("k", "exact"))
def bq_scan_neg_topk(queries_packed, codes_packed, valid, *, k: int,
                     exact: bool = False):
    """Hamming top-k over packed codes.

    ``queries_packed [Q, W]`` / ``codes_packed [N, W]`` uint32,
    ``valid [N]`` bool (tombstones). Returns ``(neg_hamming [Q, k] f32,
    ids [Q, k] int32)`` — negated so larger is better, matching every other
    ``*_neg_topk`` merge key (invalid rows carry -inf / id untrimmed).

    Approximation disclosure: scans large enough to take the multi-block
    matmul path use ``lax.approx_max_k`` (recall_target 0.95)
    for the per-block selection — candidates at the shortlist TAIL may be
    swapped for equal-or-near Hamming ties, which is recall-free when the
    caller oversamples for a rerank but makes the raw result set
    approximate. Pass ``exact=True`` to force exact per-block selection
    (FlatStore does this automatically when ``bq_rerank=False``, where
    these values ARE the final ranking). On GPU and CPU, XLA lowers both
    forms to exact selection.
    """
    q, w = queries_packed.shape
    n = codes_packed.shape[0]
    kk = min(k, n)

    # Large scans take the matmul path (_matmul_hamming_block): the
    # popcount form is elementwise-bound and, budget-blocked at 10M rows,
    # slow; the ±1-matmul form rides the int8 tensor cores. Block size bounds
    # the unpacked [B, W*32] int8 + [Q, B] s32 transients together.
    if q * n * w * 4 > _BQ_TRANSIENT_BYTES and n % _ALIGN == 0:
        d32 = w * 32
        qi = _unpack_pm1(queries_packed, d32)
        bpr = d32 + 4 * q  # transient bytes per corpus row
        block = max(_ALIGN,
                    (_BQ_TRANSIENT_BYTES // bpr) // _ALIGN * _ALIGN)
        while n % block:
            block -= _ALIGN  # terminates: n % _ALIGN == 0
        blocks = n // block
        if exact:
            kb = min(kk, block)
        else:
            # capped per-block keep (the deep-oversample fix): a
            # k*64-wide per-block selection plus a blocks*kk-wide final
            # sort dominated the whole 10M scan (selection cost, not the
            # rerank gather). The
            # global Hamming top-kk is spread ~kk/blocks per block, so
            # keeping 8x that mean (floor 64) per block preserves it
            # unless one block holds >8x its share of the winners; a
            # shortlist member lost to such crowding is replaced by its
            # blockmates — the very rows that outranked it — so the
            # rerank pool quality is unchanged. exact=True keeps the
            # uncapped width.
            kb = min(kk, block, max(64, -(-8 * kk // blocks)))
        if blocks == 1:
            neg = _matmul_hamming_block(qi, codes_packed, valid)
            return lax.top_k(neg, kk)

        def matmul_body(i):
            sl = lambda a: lax.dynamic_slice_in_dim(a, i * block, block,
                                                    axis=0)
            neg = _matmul_hamming_block(
                qi, sl(codes_packed),
                None if valid is None else sl(valid),
            )
            # per-block selection is the wall once the scan is a matmul
            # (an exact [Q, ~100k] sort per block dominated the batch);
            # ApproxTopK here is nearly free recall-wise because integer
            # Hamming distances are tie-saturated — a dropped candidate at
            # the shortlist tail is replaced by an equal-distance one and
            # the rerank re-scores both identically. CPU lowers this to an
            # exact selection, so tests stay bit-equal. exact=True opts
            # out (no-rerank stores, ground-truthing).
            if kb < neg.shape[1] and not exact:
                vals, idx = lax.approx_max_k(neg, kb, recall_target=0.95)
            else:
                vals, idx = lax.top_k(neg, kb)
            return vals, (idx + i * block).astype(jnp.int32)

        vals, ids = lax.map(matmul_body, jnp.arange(blocks))
        vals = jnp.moveaxis(vals, 0, 1).reshape(q, blocks * kb)
        ids = jnp.moveaxis(ids, 0, 1).reshape(q, blocks * kb)
        negh, midx = lax.top_k(vals, kk)
        return negh, jnp.take_along_axis(ids, midx, axis=1).astype(jnp.int32)

    blocks = _block_count(n, q, w)
    if blocks == 1:
        neg = _hamming_block(queries_packed, codes_packed, valid)
        return lax.top_k(neg, kk)
    block = n // blocks
    kb = min(kk, block)

    def scan_rows(qp):
        def body(i):
            sl = lambda a: lax.dynamic_slice_in_dim(a, i * block, block, axis=0)
            neg = _hamming_block(
                qp, sl(codes_packed),
                None if valid is None else sl(valid),
            )
            vals, idx = lax.top_k(neg, kb)
            return vals, (idx + i * block).astype(jnp.int32)

        qn = qp.shape[0]
        vals, ids = lax.map(body, jnp.arange(blocks))
        vals = jnp.moveaxis(vals, 0, 1).reshape(qn, blocks * kb)
        ids = jnp.moveaxis(ids, 0, 1).reshape(qn, blocks * kb)
        negh, midx = lax.top_k(vals, kk)
        return negh, jnp.take_along_axis(ids, midx, axis=1).astype(jnp.int32)

    # when even the finest row blocks exceed the budget (big Q x big W),
    # split the query axis so the [qc, block, W] transient stays bounded
    qc = max(1, _BQ_TRANSIENT_BYTES // (block * w * 4))
    if qc >= q:
        return scan_rows(queries_packed)
    parts = [scan_rows(queries_packed[s:s + qc]) for s in range(0, q, qc)]
    return (jnp.concatenate([p[0] for p in parts], axis=0),
            jnp.concatenate([p[1] for p in parts], axis=0))


def bq_decode(packed, dim: int) -> jnp.ndarray:
    """Unpack ``[..., W] uint32`` sign bits back to ``[..., D]`` f32 in
    {-1, +1} (the only reconstruction 1 bit supports)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)   # [..., W, 32]
    x = bits.reshape(packed.shape[:-1] + (-1,))[..., :dim]
    return jnp.where(x > 0, 1.0, -1.0).astype(jnp.float32)


def hamming_to_neg_cos_dist(neg_hamming, dim: int):
    """Map negated Hamming to negated cosine distance via the random-
    hyperplane angle estimate ``cos(theta) ~= cos(pi * H / D)``.

    Keeps BQ-only results (no rerank copy) on the same 0-100 score scale
    as every other mode. -inf (tombstone) passes through.
    """
    est_cos = jnp.cos(jnp.pi * (-neg_hamming) / float(dim))
    negd = -(1.0 - est_cos)
    return jnp.where(jnp.isinf(neg_hamming), -jnp.inf, negd)
