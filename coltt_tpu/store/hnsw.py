"""HNSW graph index: host construction, vectorized device beam search.

Reference parity: ``core/vectorindex/hnsw.go`` (Insert with greedy upper
descent + efConstruction beam per level, simple|heuristic neighbor
selection, bidirectional edges with pruneNeighbors at mMax; Search greedy to
level 0 then ef-bounded beam; Remove marks deleted + relinks neighbors;
RandomLevel from the exponential distribution), ``hnsw_config.go`` (the full
config surface: ef=20, efConstruction=200, m=16, mMax=m, mMax0=2m,
levelMultiplier=1/ln(m), Simple|Heuristic, extendCandidates/keepPruned) and
``hnsw_commit.go`` (Commit/Load binary snapshot).

Design (SURVEY.md §7 phase 7): the pointer-graph becomes
fixed-shape arrays. Search compiles to a *batched* beam: all Q queries
advance together under ``lax.while_loop``; each step expands the closest
unexpanded beam entries per query, gathers their padded neighbor rows,
dedups by comparison against the beam + expansion history (no [Q, N]
visited bitmap — a scatter is element-serialized), scores the fresh
frontier with one einsum, and merges via ``lax.top_k``. The
upper-level greedy descent is likewise a batched device walk. Deleted
vertices stay traversable (like the reference, which relinks but tolerates
tombstones mid-search) and are filtered from results.

Construction is two-mode: per-insert host numpy for the mutable serving
path (parity with hnsw.go Insert), and ``bulk_build`` — batched device
candidate beams + vectorized scatter/rebuild edge updates + a refinement
pass — for ingest-scale builds.
"""

from __future__ import annotations

import io
import math
import struct
import threading
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from coltt_tpu.ops.distance import Metric
from coltt_tpu.utils import msgcodec

_SNAPSHOT_MAGIC = b"CTTHNSW1"

SIMPLE = "simple"
HEURISTIC = "heuristic"


@dataclass(frozen=True)
class HnswConfig:
    """Full reference config surface (hnsw_config.go:57-162)."""

    m: int = 16
    m_max: Optional[int] = None          # defaults to m
    m_max0: Optional[int] = None         # defaults to 2m
    ef: int = 20
    ef_construction: int = 200
    level_multiplier: Optional[float] = None  # defaults to 1/ln(m)
    algorithm: str = SIMPLE              # simple | heuristic
    heuristic_extend_candidates: bool = False
    heuristic_keep_pruned: bool = True

    def resolved(self) -> "HnswConfig":
        out = self
        if out.m_max is None:
            out = replace(out, m_max=out.m)
        if out.m_max0 is None:
            out = replace(out, m_max0=2 * out.m)
        if out.level_multiplier is None:
            out = replace(out, level_multiplier=1.0 / math.log(out.m))
        if out.algorithm not in (SIMPLE, HEURISTIC):
            raise ValueError(f"unknown algorithm {out.algorithm!r}")
        return out

    def to_dict(self) -> dict:
        c = self.resolved()
        return {
            "m": c.m, "m_max": c.m_max, "m_max0": c.m_max0, "ef": c.ef,
            "ef_construction": c.ef_construction,
            "level_multiplier": c.level_multiplier,
            "algorithm": c.algorithm,
            "heuristic_extend_candidates": c.heuristic_extend_candidates,
            "heuristic_keep_pruned": c.heuristic_keep_pruned,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HnswConfig":
        return cls(**d)


# ---------------------------------------------------------------------------
# device kernel: batched level-0 beam search
# ---------------------------------------------------------------------------

def _batched_dist(queries, vecs, sqn_q, sqn_v, metric: Metric,
                  compute_dtype=jnp.float32):
    """queries [Q,D], vecs [Q,E,D] -> [Q,E] distances (f32 accumulation).
    These are the distances search returns, so f32 operands ask for full
    f32 (a GPU runs f32 matmuls as TF32 by default)."""
    dots = jnp.einsum(
        "qd,qed->qe",
        queries.astype(compute_dtype),
        vecs.astype(compute_dtype),
        precision=(jax.lax.Precision.HIGHEST
                   if compute_dtype == jnp.float32 else None),
        preferred_element_type=jnp.float32,
    )
    if metric == Metric.COSINE:
        den = jnp.sqrt(jnp.maximum(sqn_q[:, None] * sqn_v, 1e-30))
        return 1.0 - dots / den
    return jnp.maximum(sqn_q[:, None] + sqn_v - 2.0 * dots, 0.0)


@partial(jax.jit, static_argnames=("metric", "compute_dtype", "max_hops"))
def _greedy_descent(vectors, sqnorms, adj, queries, cur, *,
                    metric: Metric, compute_dtype=jnp.float32,
                    max_hops: int = 64):
    """Batched greedy walk on one level (hnsw.go:320 greedyClosestNeighbor).

    adj [N, W] padded int32 for the level, queries [Q, D] f32, cur [Q] int32
    start vertices. Returns the per-query local minimum vertex ids [Q].
    """
    q = queries.shape[0]
    q_iota = jnp.arange(q)
    qsq = jnp.sum(queries * queries, axis=1)
    cur_v = jnp.take(vectors, cur, axis=0)
    cur_d = _batched_dist(
        queries, cur_v[:, None, :], qsq, jnp.take(sqnorms, cur)[:, None],
        metric, compute_dtype,
    )[:, 0]
    done = jnp.zeros(q, jnp.bool_)

    def cond(state):
        it, _, _, done = state
        return jnp.logical_and(it < max_hops, ~jnp.all(done))

    def body(state):
        it, cur, cur_d, done = state
        nbrs = jnp.take(adj, cur, axis=0)                 # [Q, W]
        ok = nbrs >= 0
        safe = jnp.where(ok, nbrs, 0)
        nv = jnp.take(vectors, safe, axis=0)              # [Q, W, D]
        nd = _batched_dist(
            queries, nv, qsq, jnp.take(sqnorms, safe), metric, compute_dtype
        )
        nd = jnp.where(ok, nd, jnp.inf)
        best = jnp.argmin(nd, axis=1)
        bd = nd[q_iota, best]
        improved = (bd < cur_d) & ~done
        cur = jnp.where(improved, nbrs[q_iota, best], cur)
        cur_d = jnp.where(improved, bd, cur_d)
        return it + 1, cur, cur_d, done | ~improved

    _, cur, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), cur, cur_d, done)
    )
    return cur


@partial(jax.jit, static_argnames=("metric", "compute_dtype"))
def _rebuild_rows(vectors, sqnorms, adj, row_ids, extra, *,
                  metric: Metric, compute_dtype=jnp.float32):
    """Reverse-edge insertion with pruning, vectorized over rows.

    For each row r in ``row_ids [U]``: merge its current neighbors
    ``adj[r] [W]`` with the new candidate ids ``extra[r] [P]`` (-1 pad) and
    keep the W closest to vertex r — the simple-selection form of
    pruneNeighbors (hnsw.go:449). Returns the updated adjacency."""
    existing = jnp.take(adj, row_ids, axis=0)             # [U, W]
    w = existing.shape[1]
    # drop extras already present in the row (refinement re-merges)
    dup = jnp.any(extra[:, :, None] == existing[:, None, :], axis=-1)
    extra = jnp.where(dup, -1, extra)
    allids = jnp.concatenate([existing, extra], axis=1)   # [U, W+P]
    ok = allids >= 0
    safe = jnp.where(ok, allids, 0)
    base_v = jnp.take(vectors, row_ids, axis=0).astype(jnp.float32)
    base_sq = jnp.take(sqnorms, row_ids)
    cand_v = jnp.take(vectors, safe, axis=0)              # [U, W+P, D]
    d = _batched_dist(
        base_v, cand_v, base_sq, jnp.take(sqnorms, safe), metric, compute_dtype
    )
    d = jnp.where(ok, d, jnp.inf)
    negd, sel = jax.lax.top_k(-d, w)
    new_rows = jnp.where(
        jnp.isfinite(negd), jnp.take_along_axis(allids, sel, axis=1), -1
    )
    return adj.at[row_ids].set(new_rows.astype(jnp.int32))


@partial(jax.jit, static_argnames=("m", "metric", "keep_pruned", "compute_dtype"))
def _heuristic_select(vectors, sqnorms, cand_d, cand_ids, *,
                      m: int, metric: Metric, keep_pruned: bool,
                      compute_dtype=jnp.float32):
    """Vectorized selectNeighborsHeuristic (hnsw.go:399) over B rows.

    cand_d/cand_ids are [B, C] candidate distances/ids sorted ascending
    (-1/inf padding). m greedy rounds: each round admits the closest still-
    admissible candidate, then drops candidates that are closer to it than
    to the query. keep_pruned backfills remaining slots with the pruned
    candidates in distance order. (extendCandidates is a host-path-only
    feature; the bulk builder documents that.) Returns [B, m] ids."""
    b, c = cand_ids.shape
    iota = jnp.arange(b)
    valid = cand_ids >= 0
    safe = jnp.where(valid, cand_ids, 0)
    cvec = jnp.take(vectors, safe, axis=0)          # [B, C, D]
    csq = jnp.take(sqnorms, safe)                   # [B, C]
    sel = jnp.full((b, m), -1, jnp.int32)
    chosen = jnp.zeros((b, c), jnp.bool_)
    admissible = valid

    def body(r, state):
        admissible, chosen, sel = state
        has = jnp.any(admissible, axis=1)
        pick = jnp.argmax(admissible, axis=1)       # first True (sorted by d)
        sel = sel.at[:, r].set(
            jnp.where(has, cand_ids[iota, pick], -1)
        )
        chosen = chosen.at[iota, pick].set(chosen[iota, pick] | has)
        pv = cvec[iota, pick].astype(jnp.float32)   # [B, D]
        psq = csq[iota, pick]
        dd = _batched_dist(pv, cvec, psq, csq, metric, compute_dtype)  # [B, C]
        admissible = jnp.where(
            has[:, None], admissible & (cand_d < dd), admissible
        ) & ~chosen
        return admissible, chosen, sel

    admissible, chosen, sel = jax.lax.fori_loop(
        0, m, body, (admissible, chosen, sel)
    )
    if keep_pruned:
        cnt = jnp.sum(sel >= 0, axis=1)             # [B]
        rem = valid & ~chosen
        slotpos = cnt[:, None] + jnp.cumsum(rem, axis=1) - 1
        write = rem & (slotpos < m)
        sel = sel.at[
            iota[:, None], jnp.where(write, slotpos, m)
        ].set(jnp.where(write, cand_ids, -1), mode="drop")
    return sel


@jax.jit
def _drop_self(cand_d, cand_ids, own):
    """Remove each row's own id from its candidate list (refinement pass)."""
    bad = cand_ids == own[:, None]
    d2 = jnp.where(bad, jnp.inf, cand_d)
    negd, sel = jax.lax.top_k(-d2, cand_d.shape[1])
    ids = jnp.take_along_axis(cand_ids, sel, axis=1)
    return -negd, jnp.where(jnp.isinf(negd), -1, ids)


@partial(jax.jit, static_argnames=(
    "ef", "k", "expand", "max_iters", "metric", "compute_dtype"))
def _beam_search_l0(
    vectors, sqnorms, adj0, alive, queries, entry_ids,
    *, ef: int, k: int, expand: int, max_iters: int, metric: Metric,
    compute_dtype=jnp.float32,
):
    """Batched ef-bounded best-first search on the level-0 graph.

    vectors [N,D], sqnorms [N] f32, adj0 [N,M0] int32 (-1 pad),
    alive [N] bool (False = tombstoned), queries [Q,D] f32, entry_ids [Q].
    Returns (dists [Q,k], ids [Q,k]) over alive vertices (pad id -1/inf).

    Dedup is by comparison, not a visited bitmap: a candidate is fresh iff
    it is not in the current beam and not in the expansion history
    ([Q, expand*max_iters] ids). A scatter/gather over a [Q, N] bool map
    is element-serialized and dominated the kernel (measured 34% plus it
    capped Q*N by device memory); the compare form is pure elementwise work, 3x faster at
    50k x 256d and O(Q*ef) memory. An expanded node can never re-enter
    (history); an evicted-unexpanded node may be re-scored once — harmless.
    """
    q = queries.shape[0]
    m0 = adj0.shape[1]
    em = expand * m0
    qsq = jnp.sum(queries * queries, axis=1)
    q_iota = jnp.arange(q)

    # beam: ids [Q, ef] (-1 empty), dist [Q, ef] (+inf), expanded flag
    beam_ids = jnp.full((q, ef), -1, jnp.int32)
    beam_dist = jnp.full((q, ef), jnp.inf, jnp.float32)
    beam_exp = jnp.zeros((q, ef), jnp.bool_)

    e_vec = jnp.take(vectors, entry_ids, axis=0)
    e_sqn = jnp.take(sqnorms, entry_ids)
    d0 = _batched_dist(
        queries, e_vec[:, None, :], qsq, e_sqn[:, None], metric, compute_dtype
    )[:, 0]
    beam_ids = beam_ids.at[:, 0].set(entry_ids)
    beam_dist = beam_dist.at[:, 0].set(d0)

    hist = jnp.full((q, expand * max_iters), -1, jnp.int32)

    def cond(state):
        it, _, beam_dist, beam_exp, _ = state
        frontier = jnp.where(beam_exp, jnp.inf, beam_dist)
        has_work = jnp.any(jnp.isfinite(frontier))
        return jnp.logical_and(it < max_iters, has_work)

    def body(state):
        it, beam_ids, beam_dist, beam_exp, hist = state
        # pick the `expand` closest unexpanded beam entries per query
        frontier = jnp.where(beam_exp, jnp.inf, beam_dist)
        _, pick = jax.lax.top_k(-frontier, expand)              # [Q, E]
        pick_ids = jnp.take_along_axis(beam_ids, pick, axis=1)  # [Q, E]
        pick_live = jnp.isfinite(jnp.take_along_axis(frontier, pick, axis=1))
        beam_exp = beam_exp.at[q_iota[:, None], pick].set(
            jnp.take_along_axis(beam_exp, pick, axis=1) | pick_live
        )
        hist = jax.lax.dynamic_update_slice(
            hist, jnp.where(pick_live, pick_ids, -1),
            (jnp.int32(0), it * expand),
        )

        safe_pick = jnp.where(pick_live & (pick_ids >= 0), pick_ids, 0)
        nbrs = jnp.take(adj0, safe_pick, axis=0).reshape(q, em)
        nbr_ok = (nbrs >= 0) & jnp.repeat(pick_live, m0, axis=1)
        safe_nbrs = jnp.where(nbr_ok, nbrs, 0)

        # fresh = not in beam, not already expanded, first in-row occurrence
        in_beam = jnp.any(
            safe_nbrs[:, :, None] == beam_ids[:, None, :], axis=2
        )
        in_hist = jnp.any(
            safe_nbrs[:, :, None] == hist[:, None, :], axis=2
        )
        fresh = nbr_ok & ~in_beam & ~in_hist
        first_hit = (
            jnp.argmax(
                (safe_nbrs[:, :, None] == safe_nbrs[:, None, :])
                & fresh[:, None, :],
                axis=2,
            )
            == jnp.arange(em)[None, :]
        )
        fresh = fresh & first_hit

        nvecs = jnp.take(vectors, safe_nbrs, axis=0)       # [Q, EM, D]
        nsqn = jnp.take(sqnorms, safe_nbrs)                # [Q, EM]
        ndist = _batched_dist(queries, nvecs, qsq, nsqn, metric, compute_dtype)
        ndist = jnp.where(fresh, ndist, jnp.inf)

        all_ids = jnp.concatenate([beam_ids, nbrs], axis=1)
        all_dist = jnp.concatenate([beam_dist, ndist], axis=1)
        all_exp = jnp.concatenate(
            [beam_exp, jnp.ones((q, em), jnp.bool_)], axis=1
        )
        # fresh entries are unexpanded
        all_exp = all_exp.at[:, ef:].set(~fresh)

        negd, sel = jax.lax.top_k(-all_dist, ef)
        beam_ids = jnp.take_along_axis(all_ids, sel, axis=1)
        beam_dist = -negd
        beam_exp = jnp.take_along_axis(all_exp, sel, axis=1)
        return it + 1, beam_ids, beam_dist, beam_exp, hist

    _, beam_ids, beam_dist, beam_exp, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), beam_ids, beam_dist, beam_exp, hist)
    )

    # filter tombstoned vertices from results
    safe = jnp.where(beam_ids >= 0, beam_ids, 0)
    ok = (beam_ids >= 0) & jnp.take(alive, safe)
    final = jnp.where(ok, beam_dist, jnp.inf)
    negd, sel = jax.lax.top_k(-final, min(k, ef))
    ids = jnp.take_along_axis(beam_ids, sel, axis=1)
    dists = -negd
    ids = jnp.where(jnp.isinf(dists), -1, ids)
    return dists, ids


# ---------------------------------------------------------------------------
# clustered-build device kernels (bulk_build_clustered)
# ---------------------------------------------------------------------------

def _pow2_ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@partial(jax.jit, static_argnames=("cosine",))
def _lloyd_step(xs, cents, *, cosine: bool):
    """One Lloyd iteration, all matrix products: assignment is a matmul argmax, the
    update a one-hot einsum. ``xs`` is f32 (unit-norm for cosine); empty
    clusters keep their previous centroid."""
    if cosine:
        sims = xs @ cents.T
    else:
        sims = 2.0 * (xs @ cents.T) - jnp.sum(cents * cents, axis=1)[None, :]
    best = jnp.argmax(sims, axis=1)
    onehot = (
        best[:, None] == jnp.arange(cents.shape[0])[None, :]
    ).astype(jnp.float32)
    sums = jnp.einsum("sc,sd->cd", onehot, xs)
    cnt = jnp.sum(onehot, axis=0)
    new = jnp.where(
        cnt[:, None] > 0, sums / jnp.maximum(cnt, 1.0)[:, None], cents
    )
    if cosine:
        new = new / jnp.maximum(
            jnp.linalg.norm(new, axis=1, keepdims=True), 1e-30
        )
    return new


@partial(jax.jit, static_argnames=("spill", "cosine"))
def _assign_spill(x, cents, *, spill: int, cosine: bool):
    """Top-``spill`` nearest clusters per row. For cosine the row norm
    scales every cluster score equally, so the raw dot ranking suffices."""
    xf = x.astype(jnp.float32)
    if cosine:
        sims = xf @ cents.T
    else:
        sims = 2.0 * (xf @ cents.T) - jnp.sum(cents * cents, axis=1)[None, :]
    _, idx = jax.lax.top_k(sims, spill)
    return idx.astype(jnp.int32)


@partial(jax.jit, static_argnames=(
    "efc", "m", "metric", "heuristic", "keep_pruned", "compute_dtype"))
def _cluster_connect(d_vecs, d_sqn, q_gids, col_gids, col_valid, *,
                     efc: int, m: int, metric: Metric, heuristic: bool,
                     keep_pruned: bool, compute_dtype):
    """Forward-edge selection for one cluster block: ONE [rows, cols]
    contraction scores every member against the cluster's columns (members
    + spill-ins), top-efConstruction forms the candidate list, and the
    (optionally heuristic) selection picks the m forward neighbors.
    Returns [rows, m] global ids (-1 pad)."""
    qv = jnp.take(d_vecs, q_gids, axis=0)
    qs = jnp.take(d_sqn, q_gids)
    cv = jnp.take(d_vecs, col_gids, axis=0)
    cs = jnp.take(d_sqn, col_gids)
    dots = jnp.einsum(
        "qd,cd->qc", qv.astype(compute_dtype), cv.astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    if metric == Metric.COSINE:
        den = jnp.sqrt(jnp.maximum(qs[:, None] * cs[None, :], 1e-30))
        dist = 1.0 - dots / den
    else:
        dist = jnp.maximum(qs[:, None] + cs[None, :] - 2.0 * dots, 0.0)
    mask = col_valid[None, :] & (col_gids[None, :] != q_gids[:, None])
    dist = jnp.where(mask, dist, jnp.inf)
    kk = min(efc, dist.shape[1])
    if dist.shape[1] >= 4 * kk:
        neg, sel = jax.lax.approx_max_k(-dist, kk, recall_target=0.95)
    else:
        neg, sel = jax.lax.top_k(-dist, kk)
    cand_d = -neg
    cand_ids = jnp.where(
        jnp.isfinite(neg), jnp.take(col_gids, sel, axis=0), -1
    ).astype(jnp.int32)
    if heuristic:
        return _heuristic_select(
            d_vecs, d_sqn, cand_d, cand_ids, m=m, metric=metric,
            keep_pruned=keep_pruned, compute_dtype=compute_dtype,
        )
    return cand_ids[:, :m]


@partial(jax.jit, static_argnames=(
    "efc", "m", "metric", "heuristic", "keep_pruned", "compute_dtype"))
def _nn_descent_block(d_vecs, d_sqn, adj, rows, rand, *, efc: int, m: int,
                      metric: Metric, heuristic: bool, keep_pruned: bool,
                      compute_dtype):
    """One NN-descent candidate pass for ``rows [B]``: candidates are the
    row's current neighbors PLUS its neighbors' neighbors PLUS ``rand``
    uniformly sampled rows — two gathers and one einsum, no while_loop —
    then top-efConstruction + (heuristic) selection picks the new m
    forward edges. The random candidates are load-bearing on a
    cluster-partitioned init: neighbors-of-neighbors of intra-cluster
    edges stay intra-cluster, so without them a round barely moves
    recall (measured +.01 at 1M x 128d); random rows that the heuristic's
    diversity rule keeps are exactly the long-range edges the partition
    misses (classic NN-descent starts from a RANDOM graph for this
    reason). Returns [B, m] global ids (-1 pad)."""
    b = rows.shape[0]
    nb = jnp.take(adj, rows, axis=0)                       # [B, W]
    w = nb.shape[1]
    safe_nb = jnp.where(nb >= 0, nb, rows[:, None])
    nn = jnp.take(adj, safe_nb.reshape(-1), axis=0).reshape(b, w * w)
    cand = jnp.concatenate([safe_nb, nn, rand], axis=1)    # [B, W+W*W+R]
    cand = jnp.where(cand == rows[:, None], -1, cand)      # drop self
    # dedup by sort + adjacent-equality (an all-pairs compare is [B, C, C]
    # — 4.6 GB at C~1k — the sort is the memory-sane form)
    cand = jnp.sort(cand, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.bool_), cand[:, 1:] == cand[:, :-1]], axis=1
    )
    ok = (cand >= 0) & ~dup
    safe = jnp.where(ok, cand, 0)
    qv = jnp.take(d_vecs, rows, axis=0).astype(jnp.float32)
    qs = jnp.take(d_sqn, rows)
    cv = jnp.take(d_vecs, safe, axis=0)                    # [B, C, D]
    cs = jnp.take(d_sqn, safe)
    d = _batched_dist(qv, cv, qs, cs, metric, compute_dtype)
    d = jnp.where(ok, d, jnp.inf)
    kk = min(efc, d.shape[1])
    neg, sel = jax.lax.top_k(-d, kk)
    cand_d = -neg
    cand_ids = jnp.where(
        jnp.isfinite(neg), jnp.take_along_axis(cand, sel, axis=1), -1
    ).astype(jnp.int32)
    if heuristic:
        return _heuristic_select(
            d_vecs, d_sqn, cand_d, cand_ids, m=m, metric=metric,
            keep_pruned=keep_pruned, compute_dtype=compute_dtype,
        )
    return cand_ids[:, :m]


# ---------------------------------------------------------------------------
# host index
# ---------------------------------------------------------------------------

def _locked(fn):
    """Serialize a mutating HnswIndex method under the index lock (RLock:
    bulk builds re-enter through insert)."""
    def wrapper(self, *a, **kw):
        with self._mu:
            return fn(self, *a, **kw)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


class HnswIndex:
    """HNSW over dense int slots (the engine maps external ids <-> slots)."""

    def __init__(
        self,
        dim: int,
        *,
        metric: Metric = Metric.COSINE,
        config: Optional[HnswConfig] = None,
        seed: int = 0,
        base_capacity: int = 1024,
        device_dtype=jnp.float32,
    ):
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        if self.metric == Metric.MANHATTAN:
            raise ValueError("HNSW supports cosine/euclidean")
        self.config = (config or HnswConfig()).resolved()
        # storage/compute dtype of the device-side graph used by batched
        # search (bf16 halves memory and doubles the matmul rate; accumulation stays
        # f32). Host construction always computes in f32.
        self.device_dtype = device_dtype
        self._rng = np.random.default_rng(seed)

        cap = max(base_capacity, 1024)
        self._vecs = np.zeros((cap, self.dim), np.float32)
        self._sqn = np.zeros(cap, np.float32)
        self._levels = np.full(cap, -1, np.int32)   # -1 = unallocated
        self._alive = np.zeros(cap, bool)
        # adjacency: level -> [cap_l, width] padded int32 (-1)
        self._adj: List[np.ndarray] = [
            np.full((cap, self.config.m_max0), -1, np.int32)
        ]
        self._count = 0
        self._next = 0
        self._entry = -1          # entrypoint slot
        self._max_level = 0
        self._device_cache = None  # capacity-shaped; see _device_graph
        self._dirty: set = set()   # host rows newer than the device cache
        # one lock makes concurrent insert/remove vs search safe (the
        # reference carries per-vertex locks here, hnsw.go:50-51 /
        # hnsw_vertex.go:32-40): mutations and the host-side parts of
        # search (cache build/update, host-path walks) serialize; the
        # batched device search itself runs on an immutable snapshot and
        # needs no lock. RLock because insert/remove call helpers that
        # also take it.
        self._mu = threading.RLock()

    # -- internals ----------------------------------------------------------
    def _invalidate_cache(self) -> None:
        self._device_cache = None
        self._dirty.clear()

    def _ensure_capacity(self, n: int) -> None:
        cap = self._vecs.shape[0]
        if n <= cap:
            return
        self._invalidate_cache()  # capacity-shaped cache no longer fits
        new = cap
        while new < n:
            new *= 2
        grow = new - cap
        self._vecs = np.concatenate([self._vecs, np.zeros((grow, self.dim), np.float32)])
        self._sqn = np.concatenate([self._sqn, np.zeros(grow, np.float32)])
        self._levels = np.concatenate([self._levels, np.full(grow, -1, np.int32)])
        self._alive = np.concatenate([self._alive, np.zeros(grow, bool)])
        for lvl in range(len(self._adj)):
            w = self._adj[lvl].shape[1]
            self._adj[lvl] = np.concatenate(
                [self._adj[lvl], np.full((grow, w), -1, np.int32)]
            )

    def _ensure_level(self, level: int) -> None:
        if len(self._adj) <= level:
            self._invalidate_cache()  # cache carries one array per level
        while len(self._adj) <= level:
            self._adj.append(
                np.full((self._vecs.shape[0], self.config.m_max), -1, np.int32)
            )

    def _dist_many(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        v = self._vecs[ids]
        dots = v @ q
        if self.metric == Metric.COSINE:
            qn = math.sqrt(float(q @ q)) or 1e-30
            vn = np.sqrt(np.maximum(self._sqn[ids], 1e-30))
            return 1.0 - dots / (qn * vn)
        return np.maximum(float(q @ q) + self._sqn[ids] - 2.0 * dots, 0.0)

    def random_level(self) -> int:
        # RandomLevel parity (hnsw.go:280-282): floor(-ln(U) * mL)
        u = self._rng.random()
        return int(-math.log(max(u, 1e-12)) * self.config.level_multiplier)

    # -- greedy upper descent (hnsw.go:320 greedyClosestNeighbor) -----------
    def _greedy_level(self, q: np.ndarray, start: int, level: int) -> int:
        cur = start
        cur_d = float(self._dist_many(q, np.array([cur]))[0])
        while True:
            nbrs = self._adj[level][cur]
            nbrs = nbrs[nbrs >= 0]
            if nbrs.size == 0:
                return cur
            ds = self._dist_many(q, nbrs)
            j = int(np.argmin(ds))
            if ds[j] < cur_d:
                cur, cur_d = int(nbrs[j]), float(ds[j])
            else:
                return cur

    # -- beam search on one level (hnsw.go:345 searchLevel), host numpy -----
    def _search_level(self, q: np.ndarray, entry: int, ef: int, level: int
                      ) -> List[Tuple[float, int]]:
        import heapq

        d0 = float(self._dist_many(q, np.array([entry]))[0])
        visited = {entry}
        cand = [(d0, entry)]                  # min-heap of frontier
        best: List[Tuple[float, int]] = [(-d0, entry)]  # max-heap (neg) of results
        while cand:
            d, node = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            nbrs = self._adj[level][node]
            nbrs = [int(x) for x in nbrs[nbrs >= 0] if int(x) not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            ds = self._dist_many(q, np.array(nbrs))
            for nd, nn in zip(ds, nbrs):
                nd = float(nd)
                if len(best) < ef or nd < -best[0][0]:
                    heapq.heappush(cand, (nd, nn))
                    heapq.heappush(best, (-nd, nn))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted([(-d, n) for d, n in best])

    # -- neighbor selection (hnsw.go:399 selectNeighborsHeuristic) ----------
    def _select_neighbors(
        self, q: np.ndarray, candidates: List[Tuple[float, int]], m: int, level: int
    ) -> List[int]:
        if self.config.algorithm == SIMPLE or len(candidates) <= m:
            return [n for _, n in sorted(candidates)[:m]]
        cand = sorted(candidates)
        if self.config.heuristic_extend_candidates:
            seen = {n for _, n in cand}
            extra = []
            for _, n in list(cand):
                for nb in self._adj[level][n]:
                    nb = int(nb)
                    if nb >= 0 and nb not in seen:
                        seen.add(nb)
                        extra.append(nb)
            if extra:
                ds = self._dist_many(q, np.array(extra))
                cand = sorted(cand + list(zip(map(float, ds), extra)))
        selected: List[Tuple[float, int]] = []
        pruned: List[Tuple[float, int]] = []
        for d, n in cand:
            if len(selected) >= m:
                break
            # keep n only if it is closer to q than to any already-selected
            ok = True
            if selected:
                sel_ids = np.array([s for _, s in selected])
                dn = self._dist_many(self._vecs[n], sel_ids)
                ok = bool(np.all(d < dn))
            if ok:
                selected.append((d, n))
            else:
                pruned.append((d, n))
        if self.config.heuristic_keep_pruned:
            for d, n in pruned:
                if len(selected) >= m:
                    break
                selected.append((d, n))
        return [n for _, n in selected]

    def _add_edge(self, a: int, b: int, level: int) -> None:
        self._dirty.add(int(a))
        row = self._adj[level][a]
        if b in row:
            return
        slot = np.where(row < 0)[0]
        m_max = self.config.m_max0 if level == 0 else self.config.m_max
        if slot.size:
            row[slot[0]] = b
        else:
            # prune (hnsw.go:449 pruneNeighbors): keep best m_max among
            # existing + new by the configured selection algorithm
            ids = np.append(row[row >= 0], b)
            ds = self._dist_many(self._vecs[a], ids)
            keep = self._select_neighbors(
                self._vecs[a], list(zip(map(float, ds), map(int, ids))), m_max, level
            )
            new_row = np.full(row.shape, -1, np.int32)
            new_row[: len(keep)] = keep
            self._adj[level][a] = new_row

    # -- public API ----------------------------------------------------------
    def __len__(self) -> int:
        return self._count

    @property
    def entrypoint(self) -> int:
        return self._entry

    def insert(self, vector: np.ndarray, *, slot: Optional[int] = None,
               level: Optional[int] = None) -> int:
        """Insert (hnsw.go:104-167). Returns the slot."""
        with self._mu:
            return self._insert_locked(vector, slot=slot, level=level)

    def _insert_locked(self, vector, *, slot, level) -> int:
        q = np.asarray(vector, np.float32).reshape(-1)
        if q.shape[0] != self.dim:
            raise ValueError(f"dim {q.shape[0]} != index dim {self.dim}")
        if slot is None:
            slot = self._next
        self._next = max(self._next, slot + 1)
        self._ensure_capacity(self._next)
        if self._alive[slot] or self._levels[slot] >= 0:
            raise ValueError(f"slot {slot} already occupied")

        lvl = self.random_level() if level is None else int(level)
        self._ensure_level(lvl)
        self._vecs[slot] = q
        self._sqn[slot] = float(q @ q)
        self._levels[slot] = lvl
        self._alive[slot] = True
        self._count += 1
        self._dirty.add(int(slot))

        if self._entry < 0:
            self._entry = slot
            self._max_level = lvl
            return slot

        cur = self._entry
        # greedy descend from top level to lvl+1
        for l in range(self._max_level, lvl, -1):
            cur = self._greedy_level(q, cur, l)
        # beam + connect from min(max_level, lvl) down to 0
        for l in range(min(self._max_level, lvl), -1, -1):
            cand = self._search_level(q, cur, self.config.ef_construction, l)
            m = self.config.m
            nbrs = self._select_neighbors(q, cand, m, l)
            for nb in nbrs:
                self._add_edge(slot, nb, l)
                self._add_edge(nb, slot, l)
            if cand:
                cur = cand[0][1]
        if lvl > self._max_level:
            self._max_level = lvl
            self._entry = slot
        return slot

    # -- bulk construction ----------------------------------------------------
    def _connect_batch(self, d_vecs, d_sqn, adj, level: int,
                       new_slots: np.ndarray, cand_d, cand_ids,
                       overwrite_forward: bool = True):
        """Connect a batch of new vertices at one level (device adjacency).

        Forward edges: neighbor selection (simple top-m or the vectorized
        heuristic) over the beam candidates. Reverse edges: group by target
        row on host (ids only — bytes), then `_rebuild_rows` merges+prunes
        each affected row on device. Returns the updated adjacency array."""
        cfg = self.config
        width = cfg.m_max0 if level == 0 else cfg.m_max
        m = min(cfg.m, width)
        b = len(new_slots)  # may contain duplicate pad rows (same cand rows)
        cdt = d_vecs.dtype
        if cfg.algorithm == HEURISTIC:
            fwd_ids = _heuristic_select(
                d_vecs, d_sqn, cand_d, cand_ids,
                m=m, metric=self.metric,
                keep_pruned=cfg.heuristic_keep_pruned,
                compute_dtype=cdt,
            )
        else:
            fwd_ids = cand_ids[:, :m]
        j_slots = jnp.asarray(new_slots)
        if overwrite_forward:
            fwd_rows = jnp.full((b, width), -1, jnp.int32).at[:, :m].set(fwd_ids)
            # duplicate pad indices scatter identical rows — deterministic
            adj = adj.at[j_slots].set(fwd_rows)
        else:
            # refinement: merge fresh candidates into the existing row,
            # keeping the closest `width` (duplicates collapse via prune)
            adj = _rebuild_rows(
                d_vecs, d_sqn, adj, j_slots,
                jnp.asarray(fwd_ids).astype(jnp.int32),
                metric=self.metric, compute_dtype=cdt,
            )

        # reverse edges, grouped by neighbor row (dedup kills pad duplicates)
        f = np.asarray(fwd_ids)
        nbr = f.ravel()
        newp = np.repeat(new_slots, m)
        return self._reverse_connect(
            d_vecs, d_sqn, adj, nbr, newp, compute_dtype=cdt,
        )

    def _reverse_connect(self, d_vecs, d_sqn, adj, nbr, newp, *,
                         compute_dtype):
        """Insert reverse edges ``newp[i] -> row nbr[i]`` with pruning.

        Pairs are deduped, grouped by target row on host (ids only —
        bytes), then `_rebuild_rows` merges+prunes each affected row on
        device in power-of-two-shaped passes. Chunk padding repeats the
        chunk's LAST genuine (row, extras) pair: identical duplicate
        scatter writes are deterministic, whereas a separate pad row
        could coincide with a genuine target in the same scatter and
        XLA's duplicate-index order is undefined (ADVICE r3 item 2)."""
        keep = nbr >= 0
        nbr, newp = nbr[keep], newp[keep]
        if nbr.size == 0:
            return adj
        pair_key = nbr.astype(np.int64) * np.int64(d_vecs.shape[0]) + newp
        _, first = np.unique(pair_key, return_index=True)
        nbr, newp = nbr[first], newp[first]
        order = np.argsort(nbr, kind="stable")
        nbr, newp = nbr[order], newp[order]
        uniq, starts, counts = np.unique(nbr, return_index=True,
                                         return_counts=True)
        p = 1
        while p < min(int(counts.max()), 32):
            p *= 2
        offset = 0
        while True:
            active = counts > offset
            if not active.any():
                break
            rows_r = uniq[active]
            cnt_r = np.minimum(counts[active] - offset, p)
            idx = starts[active][:, None] + offset + np.arange(p)[None, :]
            ok = np.arange(p)[None, :] < cnt_r[:, None]
            extras = np.where(ok, newp[np.minimum(idx, newp.size - 1)], -1)
            # chunk the rebuild: its [U, W+P, D] candidate gather is the
            # build's largest transient (a global pass can target ~N rows
            # at once — 16 GB unchunked at 1M x 128d, an instant HBM OOM)
            width = int(adj.shape[1])
            per_row = (width + p) * d_vecs.shape[1] * d_vecs.dtype.itemsize
            chunk = max(4096, _pow2_ceil((1 << 30) // max(per_row, 1)) // 2)
            for st in range(0, len(rows_r), chunk):
                rr = rows_r[st:st + chunk]
                ee = extras[st:st + chunk]
                u = len(rr)
                u_pad = _pow2_ceil(u)
                if u_pad != u:
                    rr = np.concatenate([rr, np.repeat(rr[-1:], u_pad - u)])
                    ee = np.concatenate(
                        [ee, np.repeat(ee[-1:], u_pad - u, axis=0)]
                    )
                adj = _rebuild_rows(
                    d_vecs, d_sqn, adj,
                    jnp.asarray(rr.astype(np.int32)),
                    jnp.asarray(ee.astype(np.int32)),
                    metric=self.metric, compute_dtype=compute_dtype,
                )
            offset += p
        return adj

    @_locked
    def bulk_build(
        self,
        vectors: np.ndarray,
        *,
        seed_size: int = 1024,
        batch_rows: int = 2048,
        expand: int = 16,
        refine_rounds: int = 1,
        build_dtype=jnp.bfloat16,
        levels: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Device-accelerated batch construction on an empty index.

        The sequential reference algorithm (hnsw.go:104-167, one
        searchLevel per level per insert) becomes: a small sequential host
        seed to establish the upper-level skeleton, then batches whose
        efConstruction candidate beams run on the device (`_beam_search_l0`
        over every level's padded adjacency), with forward selection
        (simple top-m or the vectorized heuristic — extendCandidates is
        host-path-only) and reverse-edge insertion + pruning as vectorized
        scatter/rebuild kernels. Points within a batch do not see each
        other as candidates (standard parallel-HNSW relaxation; reverse
        edges still connect them through shared neighbors).

        Batch insertion leaves late points with fewer reverse in-edges
        than sequential insertion would (they were never candidates for
        earlier points). ``refine_rounds`` extra passes re-search the
        *finished* graph for every point and merge the fresh candidates
        into both edge directions, which measurably restores tail recall.

        Returns the assigned slots (0..N-1 in input order).
        """
        if self._count != 0 or self._next != 0:
            raise RuntimeError("bulk_build requires an empty index")
        vecs = np.ascontiguousarray(np.asarray(vectors, np.float32))
        n, d = vecs.shape
        if d != self.dim:
            raise ValueError(f"dim {d} != index dim {self.dim}")
        if n == 0:
            return np.zeros(0, np.int32)
        cfg = self.config
        if levels is None:
            u = self._rng.random(n)
            levels = np.floor(
                -np.log(np.maximum(u, 1e-12)) * cfg.level_multiplier
            ).astype(np.int32)
        else:
            levels = np.asarray(levels, np.int32)

        self._ensure_capacity(n)
        self._ensure_level(int(levels.max(initial=0)))

        # 1) sequential host seed — defines the upper-level skeleton
        seed = max(1, min(seed_size, n))
        for i in range(seed):
            self.insert(vecs[i], slot=i, level=int(levels[i]))
        if seed == n:
            return np.arange(n, dtype=np.int32)

        # stage remaining rows into the host arrays (alive set per batch)
        self._vecs[seed:n] = vecs[seed:]
        self._sqn[seed:n] = np.einsum(
            "nd,nd->n", vecs[seed:], vecs[seed:], dtype=np.float32
        )
        self._levels[seed:n] = levels[seed:]
        self._next = n

        # device state over the full (pow2) capacity; future rows prefilled
        # (unreachable until edges point at them). Candidate gathers are the
        # build's HBM bottleneck — bf16 storage halves the traffic; all
        # distance accumulation stays f32.
        d_vecs = jnp.asarray(self._vecs).astype(build_dtype)
        d_sqn = jnp.asarray(self._sqn)
        d_alive = jnp.asarray(self._alive)
        d_adj = [jnp.asarray(a) for a in self._adj]
        efc = cfg.ef_construction
        max_iters = max(2 * efc // max(expand, 1), 16)

        def pow2_batch(limit: int) -> int:
            b = 1
            while b * 2 <= limit:
                b *= 2
            return b

        pos = seed
        while pos < n:
            # power-of-two batches: bounded set of jit shapes, stable
            # compile-cache keys across runs
            b = pow2_batch(min(batch_rows, pos, n - pos))
            slots = np.arange(pos, pos + b, dtype=np.int32)
            bl = levels[pos:pos + b]
            bq = jnp.asarray(vecs[pos:pos + b])
            cur = jnp.full((b,), self._entry, jnp.int32)

            for l in range(self._max_level, 0, -1):
                cur = _greedy_descent(
                    d_vecs, d_sqn, d_adj[l], bq, cur, metric=self.metric,
                    compute_dtype=build_dtype,
                )
                need = bl >= l
                if not need.any():
                    continue
                sub = np.where(need)[0]
                u_pad = 1
                while u_pad < len(sub):
                    u_pad *= 2
                sub_pad = np.concatenate(
                    [sub, np.full(u_pad - len(sub), sub[0], sub.dtype)]
                )
                j_sub = jnp.asarray(sub_pad)
                cand_dist, cand_ids = _beam_search_l0(
                    d_vecs, d_sqn, d_adj[l], d_alive,
                    jnp.take(bq, j_sub, axis=0),
                    jnp.take(cur, j_sub),
                    ef=efc, k=efc, expand=expand, max_iters=max_iters,
                    metric=self.metric, compute_dtype=build_dtype,
                )
                d_adj[l] = self._connect_batch(
                    d_vecs, d_sqn, d_adj[l], l, slots[sub_pad],
                    cand_dist, cand_ids,
                )
                cur = cur.at[j_sub].set(cand_ids[:, 0])

            cand_dist, cand_ids = _beam_search_l0(
                d_vecs, d_sqn, d_adj[0], d_alive, bq, cur,
                ef=efc, k=efc, expand=expand, max_iters=max_iters,
                metric=self.metric, compute_dtype=build_dtype,
            )
            d_adj[0] = self._connect_batch(
                d_vecs, d_sqn, d_adj[0], 0, slots, cand_dist, cand_ids
            )

            d_alive = d_alive.at[jnp.asarray(slots)].set(True)
            self._alive[slots] = True
            self._count += b
            bmax = int(bl.max())
            if bmax > self._max_level:
                self._max_level = bmax
                self._entry = int(slots[int(np.argmax(bl))])
            pos += b

        # refinement: every point re-searches the finished graph; merges
        # (not overwrites) both edge directions. Restores the reverse
        # in-edges late batches never received.
        for _ in range(max(0, refine_rounds)):
            pos = 0
            while pos < n:
                b = pow2_batch(min(batch_rows, n - pos))
                slots = np.arange(pos, pos + b, dtype=np.int32)
                bq = jnp.asarray(vecs[pos:pos + b])
                cur = jnp.full((b,), self._entry, jnp.int32)
                for l in range(self._max_level, 0, -1):
                    cur = _greedy_descent(
                        d_vecs, d_sqn, d_adj[l], bq, cur, metric=self.metric,
                        compute_dtype=build_dtype,
                    )
                cand_dist, cand_ids = _beam_search_l0(
                    d_vecs, d_sqn, d_adj[0], d_alive, bq, cur,
                    ef=efc, k=efc, expand=expand, max_iters=max_iters,
                    metric=self.metric, compute_dtype=build_dtype,
                )
                cand_dist, cand_ids = _drop_self(
                    cand_dist, cand_ids, jnp.asarray(slots)
                )
                d_adj[0] = self._connect_batch(
                    d_vecs, d_sqn, d_adj[0], 0, slots, cand_dist, cand_ids,
                    overwrite_forward=False,
                )
                pos += b

        for l in range(len(self._adj)):
            # np.asarray over a device buffer is read-only; the host arrays
            # stay mutable for post-bulk insert/remove
            self._adj[l] = np.array(d_adj[l], copy=True)
        self._invalidate_cache()
        return np.arange(n, dtype=np.int32)

    # -- clustered bulk construction (ingest-rate path) ----------------------
    def bulk_build_auto(self, vectors: np.ndarray, **kw) -> np.ndarray:
        """Builder policy for engine ingest: the HYBRID build — clustered
        matmul candidate blocks, then one ef=32 beam-refinement round over
        the finished graph. Measured at 1M x 128d (bench_hnsw.py,
        16k-center corpus, 1024-query recall, r04):

          beam builder (r03 default)      810 rows/s   recall@10 .945
          clustered only                2,878 rows/s   .798
          clustered + NN-descent x1     1,738 rows/s   .808
          clustered + beam_refine ef64  1,216 rows/s   .9714
          clustered + beam_refine ef32  1,647 rows/s   .969   <- default

        The hybrid dominates the old beam default on BOTH axes (2x the
        ingest rate, +2.4 recall points) and reaches the reference's
        ~1.7k rows/s one-by-one insert rate: the clustered blocks supply
        dense local candidates cheaply, and the single beam round over
        the complete graph restores the cross-cluster edges the partition
        misses (ef=32 recovers within .003 of ef=64 at 35% more rate).
        Callers that want raw ingest rate use ``bulk_build_clustered``
        directly (recall trade documented there); sequential-parity
        construction remains ``insert`` / ``bulk_build``."""
        out = self.bulk_build_clustered(vectors, **kw)
        self.beam_refine(rounds=1, ef=32, batch_rows=4096)
        return out

    @_locked
    def bulk_build_clustered(
        self,
        vectors: np.ndarray,
        *,
        cluster_size: int = 2048,
        spill: int = 2,
        kmeans_iters: int = 8,
        kmeans_sample: int = 131_072,
        build_dtype=jnp.bfloat16,
        levels: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
        descent_rounds: int = 0,
    ) -> np.ndarray:
        """Matmul-native batch construction: k-means partition + per-cluster
        dense kNN blocks + heuristic selection + one global reverse pass.

        Why: ``bulk_build``'s candidate beams are row-gather bound — every
        beam iteration gathers ~expand*m0 corpus rows per query at XLA's
        ~11-76 ns/row, which capped ingest at ~810 rows/s for 1M x 768d
        (VERDICT r2 item 3). This builder generates candidates with dense
        matmuls instead: rows are k-means-partitioned (sampled Lloyd — the
        assign step is one matmul, the update one one-hot einsum), and each
        cluster scores its member rows against the cluster's rows *plus
        spill-ins* (rows whose 2nd-nearest cluster is this one) in a single
        [rows, cols] contraction. Per-row candidate lists are the
        block's top-efConstruction — two hard-won rules are load-bearing
        here: (a) candidates must run the FULL efConstruction deep
        (clamping below the data's natural cluster width strips every
        cross-cluster edge), and (b) forward edges must use the heuristic's
        RNG-style diversity pruning (simple top-m over pure kNN lists
        yields a graph whose recall plateaus ~0.6 regardless of ef).
        Spill-in columns are what stitch neighboring clusters together:
        boundary rows surface in two blocks' candidate lists and the
        reverse pass then links across the seam. Upper levels are built the
        same way over their (16x smaller per level) subsets; the level
        hierarchy restores global navigability exactly as in the
        sequential algorithm.

        Trade-off vs ``bulk_build``, measured at 1M x 128d (bench_hnsw.py,
        16k-center corpus): 2,878 rows/s vs ~810 (3.5x; the reference's
        one-by-one path is ~1.7k/s), but recall@10 at ef=128 is ~.80 vs
        the beam builder's .945 — partition-local candidate lists miss
        long-range edges the beam search discovers, and at this scale the
        spill + hierarchy only partly compensate (small corpora in the
        test suite reach .9+). This is the fast-ingest option, chosen
        explicitly; engine ingest defaults to the beam builder
        (``bulk_build_auto``). Sequential-parity construction remains
        ``insert``/``bulk_build``. Returns slots 0..N-1 in input order.
        """
        if self._count != 0 or self._next != 0:
            raise RuntimeError("bulk_build_clustered requires an empty index")
        vecs = np.ascontiguousarray(np.asarray(vectors, np.float32))
        n, d = vecs.shape
        if d != self.dim:
            raise ValueError(f"dim {d} != index dim {self.dim}")
        if n == 0:
            return np.zeros(0, np.int32)
        cfg = self.config
        rng = self._rng if seed is None else np.random.default_rng(seed)
        if levels is None:
            u = rng.random(n)
            levels = np.floor(
                -np.log(np.maximum(u, 1e-12)) * cfg.level_multiplier
            ).astype(np.int32)
        else:
            levels = np.asarray(levels, np.int32)

        self._ensure_capacity(n)
        max_level = int(levels.max(initial=0))
        self._ensure_level(max_level)
        self._vecs[:n] = vecs
        self._sqn[:n] = np.einsum("nd,nd->n", vecs, vecs, dtype=np.float32)
        self._levels[:n] = levels
        self._next = n

        d_vecs = jnp.asarray(self._vecs).astype(build_dtype)
        d_sqn = jnp.asarray(self._sqn)

        for lvl in range(max_level + 1):
            ids_l = np.arange(n, dtype=np.int32) if lvl == 0 else (
                np.where(levels >= lvl)[0].astype(np.int32)
            )
            if ids_l.size == 0:
                continue
            width = cfg.m_max0 if lvl == 0 else cfg.m_max
            adj = self._build_level_clustered(
                d_vecs, d_sqn, ids_l, jnp.asarray(self._adj[lvl]),
                width=width, cluster_size=cluster_size, spill=spill,
                kmeans_iters=kmeans_iters, kmeans_sample=kmeans_sample,
                rng=rng, compute_dtype=build_dtype,
            )
            self._adj[lvl] = np.array(adj, copy=True)

        # NN-descent refinement on level 0 (``descent_rounds`` > 0): each
        # round re-selects every row's edges from neighbors +
        # neighbors-of-neighbors against the finished graph — the hybrid
        # build that recovers the long-range/seam edges the partition
        # misses, at a fixed W+W^2 gather per row (vs the beam builder's
        # expand*m0*iters). Measured at 1M x 128d (bench_hnsw.py): see
        # bulk_build_auto for the shipped numbers/policy.
        for _ in range(max(0, descent_rounds)):
            adj0 = self._nn_descent_level(
                d_vecs, d_sqn, jnp.asarray(self._adj[0]), n,
                width=cfg.m_max0, compute_dtype=build_dtype,
            )
            self._adj[0] = np.array(adj0, copy=True)

        self._alive[:n] = True
        self._count = n
        self._max_level = max_level
        self._entry = int(np.argmax(levels))
        self._invalidate_cache()
        return np.arange(n, dtype=np.int32)

    def _build_level_clustered(self, d_vecs, d_sqn, ids_l, adj, *, width,
                               cluster_size, spill, kmeans_iters,
                               kmeans_sample, rng, compute_dtype):
        """One level of the clustered build; returns the updated device
        adjacency for that level."""
        cfg = self.config
        m = min(cfg.m, width)
        nl = ids_l.size
        cosine = self.metric == Metric.COSINE

        if nl <= max(2 * cluster_size, 256):
            members = [ids_l]           # single dense block, no partition
            spills = [np.zeros(0, np.int32)]
        else:
            c = _pow2_ceil(max(2, spill * nl // cluster_size))
            samp = ids_l if nl <= kmeans_sample else np.asarray(
                rng.choice(ids_l, size=kmeans_sample, replace=False)
            )
            xs = jnp.take(d_vecs, jnp.asarray(samp), axis=0).astype(jnp.float32)
            if cosine:
                xs = xs / jnp.maximum(
                    jnp.linalg.norm(xs, axis=1, keepdims=True), 1e-30
                )
            init = jnp.asarray(
                rng.choice(samp.size, size=c, replace=samp.size < c)
            )
            cents = jnp.take(xs, init, axis=0)
            for _ in range(kmeans_iters):
                cents = _lloyd_step(xs, cents, cosine=cosine)
            # top-`spill` cluster assignment for every row, chunked
            assign = np.empty((nl, spill), np.int32)
            chunk = 65_536
            for i in range(0, nl, chunk):
                sub = ids_l[i:i + chunk]
                pad = _pow2_ceil(sub.size) - sub.size
                sub_p = np.concatenate([sub, np.repeat(sub[:1], pad)])
                out = _assign_spill(
                    jnp.take(d_vecs, jnp.asarray(sub_p), axis=0), cents,
                    spill=spill, cosine=cosine,
                )
                assign[i:i + chunk] = np.asarray(out)[: sub.size]
            members, spills = [], []
            for ci in range(c):
                members.append(ids_l[assign[:, 0] == ci])
                spills.append(
                    ids_l[(assign[:, 1:] == ci).any(axis=1)]
                    if spill > 1 else np.zeros(0, np.int32)
                )

        # phase 1: dispatch per-cluster candidate + forward selection
        pending = []  # (member_rows, fwd_device)
        for rows, sp in zip(members, spills):
            if rows.size == 0:
                continue
            cols = np.concatenate([rows, sp])
            cpad = _pow2_ceil(max(cols.size, 256))
            col_valid = np.zeros(cpad, bool)
            col_valid[: cols.size] = True
            cols_p = np.concatenate(
                [cols, np.repeat(cols[:1], cpad - cols.size)]
            ).astype(np.int32)
            j_cols = jnp.asarray(cols_p)
            j_cvalid = jnp.asarray(col_valid)
            qchunk = 1024
            for i in range(0, rows.size, qchunk):
                sub = rows[i:i + qchunk]
                qpad = min(_pow2_ceil(sub.size), qchunk)
                sub_p = np.concatenate(
                    [sub, np.repeat(sub[:1], qpad - sub.size)]
                ).astype(np.int32)
                fwd = _cluster_connect(
                    d_vecs, d_sqn, jnp.asarray(sub_p), j_cols, j_cvalid,
                    efc=cfg.ef_construction, m=m, metric=self.metric,
                    heuristic=cfg.algorithm == HEURISTIC,
                    keep_pruned=cfg.heuristic_keep_pruned,
                    compute_dtype=compute_dtype,
                )
                rowspec = jnp.asarray(sub_p)
                fwd_rows = (
                    jnp.full((qpad, width), -1, jnp.int32).at[:, :m].set(fwd)
                )
                adj = adj.at[rowspec].set(fwd_rows)
                pending.append((sub, fwd))

        # phase 2: fetch forward lists (pipelined), one global reverse pass
        nbr_parts, new_parts = [], []
        for sub, fwd in pending:
            f = np.asarray(fwd)[: sub.size]           # [B, m]
            nbr_parts.append(f.ravel())
            new_parts.append(np.repeat(sub, f.shape[1]))
        if nbr_parts:
            adj = self._reverse_connect(
                d_vecs, d_sqn, adj,
                np.concatenate(nbr_parts), np.concatenate(new_parts),
                compute_dtype=compute_dtype,
            )
        return adj

    @_locked
    def beam_refine(self, *, rounds: int = 1, batch_rows: int = 2048,
                    expand: int = 16, ef: Optional[int] = None,
                    build_dtype=jnp.bfloat16) -> None:
        """Beam-refinement rounds over the FINISHED graph: every point
        re-searches level 0 with the batched device beam and merges the
        fresh candidates into both edge directions — ``bulk_build``'s
        refinement loop exposed as a standalone pass, so the clustered
        builder's graph can recover the long-range edges its
        partition-local candidate blocks miss (VERDICT r3 item 4a).
        ``ef`` defaults to ef_construction; smaller values trade recall
        recovery for refinement cost (the beam's gather volume scales
        ~ef). Works on any built index."""
        if self._count == 0:
            return
        cfg = self.config
        n = self._next
        efc = cfg.ef_construction if ef is None else max(int(ef), cfg.m)
        max_iters = max(2 * efc // max(expand, 1), 16)
        d_vecs = jnp.asarray(self._vecs).astype(build_dtype)
        d_sqn = jnp.asarray(self._sqn)
        d_alive = jnp.asarray(self._alive)
        d_adj = [jnp.asarray(a) for a in self._adj]

        def pow2_batch(limit: int) -> int:
            b = 1
            while b * 2 <= limit:
                b *= 2
            return b

        for _ in range(max(0, rounds)):
            pos = 0
            while pos < n:
                b = pow2_batch(min(batch_rows, n - pos))
                slots = np.arange(pos, pos + b, dtype=np.int32)
                bq = jnp.asarray(self._vecs[pos:pos + b])
                cur = jnp.full((b,), self._entry, jnp.int32)
                for l in range(min(self._max_level, len(d_adj) - 1), 0, -1):
                    cur = _greedy_descent(
                        d_vecs, d_sqn, d_adj[l], bq, cur, metric=self.metric,
                        compute_dtype=build_dtype,
                    )
                cand_dist, cand_ids = _beam_search_l0(
                    d_vecs, d_sqn, d_adj[0], d_alive, bq, cur,
                    ef=efc, k=efc, expand=expand, max_iters=max_iters,
                    metric=self.metric, compute_dtype=build_dtype,
                )
                cand_dist, cand_ids = _drop_self(
                    cand_dist, cand_ids, jnp.asarray(slots)
                )
                d_adj[0] = self._connect_batch(
                    d_vecs, d_sqn, d_adj[0], 0, slots, cand_dist, cand_ids,
                    overwrite_forward=False,
                )
                pos += b
        self._adj[0] = np.array(d_adj[0], copy=True)
        self._invalidate_cache()

    def _nn_descent_level(self, d_vecs, d_sqn, adj, n: int, *, width: int,
                          compute_dtype, rand_cands: int = 32
                          ) -> "jnp.ndarray":
        """One NN-descent round over rows 0..n-1 of one level: phase 1
        computes every row's new forward selection against the OLD graph
        (pipelined pow2 device batches), phase 2 applies the forward
        overwrites and one global reverse pass. Returns the new device
        adjacency."""
        cfg = self.config
        m = min(cfg.m, width)
        c = width + width * width + rand_cands
        # bound the [B, C, D] candidate gather transient to ~1 GB
        per_row = c * d_vecs.shape[1] * d_vecs.dtype.itemsize
        batch_rows = max(256, _pow2_ceil((1 << 30) // max(per_row, 1)) // 2)
        pending = []
        for pos in range(0, n, batch_rows):
            sub = np.arange(pos, min(pos + batch_rows, n), dtype=np.int32)
            pad = _pow2_ceil(sub.size)
            sub_p = (np.concatenate([sub, np.repeat(sub[-1:], pad - sub.size)])
                     if pad != sub.size else sub)
            rand = self._rng.integers(
                0, n, (sub_p.size, max(rand_cands, 1)), dtype=np.int32
            )
            fwd = _nn_descent_block(
                d_vecs, d_sqn, adj, jnp.asarray(sub_p), jnp.asarray(rand),
                efc=cfg.ef_construction, m=m, metric=self.metric,
                heuristic=cfg.algorithm == HEURISTIC,
                keep_pruned=cfg.heuristic_keep_pruned,
                compute_dtype=compute_dtype,
            )
            pending.append((sub, sub_p, fwd))
        nbr_parts, new_parts = [], []
        for sub, sub_p, fwd in pending:
            rows_full = (
                jnp.full((fwd.shape[0], width), -1, jnp.int32)
                .at[:, :m].set(fwd)
            )
            # duplicate pad rows scatter identical content — deterministic
            adj = adj.at[jnp.asarray(sub_p)].set(rows_full)
            f = np.asarray(fwd)[: sub.size]
            nbr_parts.append(f.ravel())
            new_parts.append(np.repeat(sub, f.shape[1]))
        return self._reverse_connect(
            d_vecs, d_sqn, adj,
            np.concatenate(nbr_parts), np.concatenate(new_parts),
            compute_dtype=compute_dtype,
        )

    def remove(self, slot: int) -> bool:
        """Remove (hnsw.go:191-242): tombstone + relink neighbors so the
        graph stays connected through the hole."""
        with self._mu:
            return self._remove_locked(slot)

    def _remove_locked(self, slot: int) -> bool:
        if slot < 0 or slot >= self._levels.shape[0] or not self._alive[slot]:
            return False
        self._alive[slot] = False
        self._count -= 1
        self._dirty.add(int(slot))
        for l in range(int(self._levels[slot]) + 1):
            nbrs = self._adj[l][slot]
            nbrs = [int(x) for x in nbrs[nbrs >= 0] if self._alive[int(x)]]
            # connect surviving neighbors pairwise (bounded)
            for i, a in enumerate(nbrs):
                for b in nbrs[i + 1:]:
                    self._add_edge(a, b, l)
                    self._add_edge(b, a, l)
        if slot == self._entry:
            # move entrypoint to any alive vertex at the highest level
            self._entry = -1
            for l in range(self._max_level, -1, -1):
                alive_at = np.where(self._alive & (self._levels >= l))[0]
                if alive_at.size:
                    self._entry = int(alive_at[0])
                    self._max_level = l
                    break
            if self._entry < 0:
                self._max_level = 0
        return True

    # -- search --------------------------------------------------------------
    def _device_graph(self):
        """Device-side graph snapshot, *capacity*-shaped and incrementally
        updated. Mutations record their touched rows in ``_dirty`` and the
        next search scatters only those rows into the cached device arrays
        — a mutate->search transition costs O(dirty rows) of transfer, not
        a full re-upload (~1.5 GB+ at 1M x 768d bf16, VERDICT r3 weak #6).
        Capacity-shaped (pow2-grown) arrays also keep the search kernels'
        jit shapes stable across inserts: the old ``[:next]`` slicing
        recompiled the beam kernels after EVERY insert. Full rebuilds
        happen only on capacity growth, level-count change, or bulk
        builds. Callers hold ``_mu``; unallocated rows are alive=False
        with -1 adjacency, unreachable by construction."""
        c = self._device_cache
        cap = self._vecs.shape[0]
        if c is not None and (c[0].shape[0] != cap
                              or len(c[4]) != len(self._adj) - 1):
            c = None
            self._dirty.clear()
        if c is None:
            self._device_cache = (
                jnp.asarray(self._vecs).astype(self.device_dtype),
                jnp.asarray(self._sqn),
                jnp.asarray(self._adj[0]),
                jnp.asarray(self._alive),
                tuple(jnp.asarray(a) for a in self._adj[1:]),
            )
            self._dirty.clear()
        elif self._dirty:
            rows = np.fromiter(self._dirty, np.int32, len(self._dirty))
            self._dirty.clear()
            u_pad = _pow2_ceil(len(rows))  # bounded set of scatter shapes
            if u_pad != len(rows):
                # identical duplicate writes are deterministic
                rows = np.concatenate(
                    [rows, np.repeat(rows[-1:], u_pad - len(rows))]
                )
            j = jnp.asarray(rows)
            vecs, sqn, adj0, alive, upper = self._device_cache
            self._device_cache = (
                vecs.at[j].set(
                    jnp.asarray(self._vecs[rows]).astype(self.device_dtype)
                ),
                sqn.at[j].set(jnp.asarray(self._sqn[rows])),
                adj0.at[j].set(jnp.asarray(self._adj[0][rows])),
                alive.at[j].set(jnp.asarray(self._alive[rows])),
                tuple(
                    a.at[j].set(jnp.asarray(self._adj[l + 1][rows]))
                    for l, a in enumerate(upper)
                ),
            )
        return self._device_cache

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        ef: Optional[int] = None,
        expand: int = 16,  # sweep on 1M x 128d: expand 4/8/16 -> 2048/2680/3045
        # QPS at equal recall (fewer while_loop iterations, same total
        # neighbor expansions)
        device: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched top-k search. Returns (dists [Q,k], slots [Q,k]); missing
        results carry slot -1 / dist inf."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        qn, _ = queries.shape
        ef = max(self.config.ef if ef is None else ef, k)
        with self._mu:
            if self._entry < 0 or self._count == 0:
                return (np.full((qn, k), np.inf, np.float32),
                        np.full((qn, k), -1, np.int32))

            if not device:
                # upper-level descent + level-0 beam on host — walks the
                # mutable host arrays, so it holds the lock throughout
                dists = np.full((qn, k), np.inf, np.float32)
                slots = np.full((qn, k), -1, np.int32)
                for i in range(qn):
                    cur = self._entry
                    for l in range(self._max_level, 0, -1):
                        cur = self._greedy_level(queries[i], cur, l)
                    res = [
                        (d, nid)
                        for d, nid in self._search_level(queries[i], cur, ef, 0)
                        if self._alive[nid]
                    ][:k]
                    for j, (d, nid) in enumerate(res):
                        dists[i, j] = d
                        slots[i, j] = nid
                return dists, slots

            # snapshot under the lock; the device arrays are immutable, so
            # the beam below runs lock-free against a consistent graph
            vectors, sqn, adj0, alive, upper = self._device_graph()
            entry = self._entry
            max_level = self._max_level
        jq = jnp.asarray(queries)
        entries = jnp.full((qn,), entry, jnp.int32)
        # upper-level greedy descent, batched on device per level
        for l in range(min(max_level, len(upper)), 0, -1):
            entries = _greedy_descent(
                vectors, sqn, upper[l - 1], jq, entries,
                metric=self.metric, compute_dtype=self.device_dtype,
            )
        max_iters = max(2 * ef // max(expand, 1), 8)
        d, ids = _beam_search_l0(
            vectors, sqn, adj0, alive, jq, entries,
            ef=ef, k=k, expand=expand, max_iters=max_iters, metric=self.metric,
            compute_dtype=self.device_dtype,
        )
        from coltt_tpu.ops.topk import fetch_scores_ids

        d, ids = fetch_scores_ids(d, ids)
        if d.shape[1] < k:
            pad = k - d.shape[1]
            d = np.concatenate([d, np.full((qn, pad), np.inf, np.float32)], axis=1)
            ids = np.concatenate([ids, np.full((qn, pad), -1, np.int32)], axis=1)
        return d, ids

    # -- snapshot (hnsw_commit.go Commit/Load parity) -------------------------
    @_locked
    def save(self, f: io.BufferedIOBase) -> None:
        n = self._next
        header = {
            "dim": self.dim,
            "metric": int(self.metric),
            "config": self.config.to_dict(),
            "entry": self._entry,
            "max_level": self._max_level,
            "count": self._count,
            "next": n,
            # binary-encode levels/alive: per-element Python lists in the
            # msgpack header cost seconds + ~40 bytes/row at 1M+ rows
            # (VERDICT r3); raw LE arrays are a memcpy
            "levels_bin": self._levels[:n].astype("<i4").tobytes(),
            "alive_bin": np.packbits(self._alive[:n]).tobytes(),
        }
        hb = msgcodec.packb(header)
        f.write(_SNAPSHOT_MAGIC)
        f.write(len(hb).to_bytes(8, "big"))
        f.write(hb)
        f.write(self._vecs[:n].tobytes())
        f.write(struct.pack(">I", len(self._adj)))
        for lvl, adj in enumerate(self._adj):
            f.write(struct.pack(">II", adj.shape[1], n))
            f.write(adj[:n].astype(">i4").tobytes())

    @classmethod
    def load(cls, f: io.BufferedIOBase) -> "HnswIndex":
        magic = f.read(len(_SNAPSHOT_MAGIC))
        if magic != _SNAPSHOT_MAGIC:
            raise ValueError("not an HNSW snapshot")
        hlen = int.from_bytes(f.read(8), "big")
        h = msgcodec.unpackb(f.read(hlen))
        idx = cls(
            h["dim"],
            metric=Metric.parse(h["metric"]),
            config=HnswConfig.from_dict(h["config"]),
            base_capacity=max(h["next"], 1024),
        )
        n = h["next"]
        vecs = np.frombuffer(f.read(n * h["dim"] * 4), np.float32).reshape(n, h["dim"])
        idx._vecs[:n] = vecs
        idx._sqn[:n] = (vecs * vecs).sum(1)
        if "levels_bin" in h:
            idx._levels[:n] = np.frombuffer(h["levels_bin"], "<i4")
            idx._alive[:n] = np.unpackbits(
                np.frombuffer(h["alive_bin"], np.uint8), count=n
            ).astype(bool)
        else:  # pre-r04 snapshots carried per-element lists
            idx._levels[:n] = np.asarray(h["levels"], np.int32)
            idx._alive[:n] = np.asarray(h["alive"], bool)
        (nlevels,) = struct.unpack(">I", f.read(4))
        idx._adj = []
        for lvl in range(nlevels):
            width, rows = struct.unpack(">II", f.read(8))
            adj = np.frombuffer(f.read(rows * width * 4), ">i4").astype(np.int32)
            full = np.full((idx._vecs.shape[0], width), -1, np.int32)
            full[:rows] = adj.reshape(rows, width)
            idx._adj.append(full)
        idx._entry = h["entry"]
        idx._max_level = h["max_level"]
        idx._count = h["count"]
        idx._next = n
        return idx
