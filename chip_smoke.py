#!/usr/bin/env python3
"""End-to-end smoke check of coltt's three engines on one NVIDIA GPU.

Drives the objects the gRPC servicers call (``EdgeEngine``, ``CoreEngine``,
``ExperimentalEngine``) at deployment size, on a cluster-mixture corpus
made from ``--seed``, and holds every phase to an independent numpy
reference computed on the host:

1. edge FLAT I8 cosine, 1M x 768: create -> index_many (string tag field)
   -> flush -> release -> load (precompiles the fused kernel) ->
   search_batch at Q = 1, 64, 2048, exact and ``high_resource`` (the fused
   Pallas kernel) -> a rare-tag and a common-tag filtered search -> an
   upsert and a delete, each seen by the next search. Also times the
   fused kernel against the XLA scan, and checks that the compiled fused
   search holds the kernel's Triton custom call.
2. edge FLAT F8 euclidean, 1M x 768: the same steps.
3. edge PQ and BQ, 200k x 768: create, index, search, reload, search.
4. core HNSW, 100k x 128: bulk_insert, search, close, reopen from the
   graph snapshot, search, then a write-ahead-log replay after an unclean
   stop.
5. experimental CFLAT, 100k rows, two vector fields weighted 70/30.
6. the served path: an edge gRPC server in this process, driven by
   ``EdgeClient`` from a thread.

Each phase prints its wall time, its persistent compile-cache hits and
misses, and its recall@10 against f32 ground truth on the raw vectors.
Any failure exits non-zero. The last line of a passing run is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage (from the root of a checkout):

    python3 chip_smoke.py              # one GPU, full size
    python3 chip_smoke.py --chips 4    # only the 4-GPU sharded edge phase
    JAX_PLATFORMS=cpu python3 chip_smoke.py --small --allow-cpu
                                       # CPU rehearsal at reduced size
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

K = 10
NREF = 64  # queries checked against the numpy references
# HNSW search beam (VectorSearchBatch's ef): the default 20 loses recall as
# the graph grows (0.98 at 8k rows, 0.88 at 64k on the rehearsal corpus;
# ef=256 holds 0.998 at 64k)
HNSW_EF = 256

# recall@10 floors against f32 ground truth: the value the --small CPU
# rehearsal gives for --seed 0 (at the SMALL sizes below), less 0.01
FLOORS = {
    "i8": 0.9588,      # 0.9688 at 16k rows
    "f8": 0.9228,      # 0.9328 at 16k rows
    "pq": 0.4416,      # 0.4516 at 64k rows (0.54 at 8k: falls with N)
    "bq": 0.9853,      # 0.9953 at 64k rows
    "hnsw": 0.9884,    # 0.9984 at 64k rows, ef=256, after log replay
    "cflat": 0.99,     # 1.0 at 4k rows (exact f32 scan)
    "served": 0.9619,  # 0.9719 at 32k rows
}


class SmokeFailure(AssertionError):
    """A phase missed one of its checks."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@dataclass(frozen=True)
class Sizes:
    flat_n: int
    pqbq_n: int
    hnsw_n: int
    cflat_n: int
    served_n: int
    sharded_n: int
    batches: tuple
    dim: int = 768
    hnsw_dim: int = 128


FULL = Sizes(flat_n=1_000_000, pqbq_n=200_000, hnsw_n=100_000,
             cflat_n=100_000, served_n=32_768, sharded_n=4_000_000,
             batches=(1, 64, 2048))
# PQ and HNSW recall falls as the corpus grows (more clusters per codebook,
# a larger graph), so their rehearsal sizes are the largest the CPU runs in
# minutes; FLAT, BQ and CFLAT recall is flat in N. The served phase is small
# enough to rehearse at full size.
SMALL = Sizes(flat_n=16_384, pqbq_n=65_536, hnsw_n=65_536, cflat_n=4_096,
              served_n=32_768, sharded_n=32_768, batches=(1, 64, 256))


# -- data -------------------------------------------------------------------

def cluster_corpus(rng, n: int, d: int, *, per: int = 32, sigma: float = 0.35,
                   scale: float = 1.0):
    """Embedding-like rows: ``n // per`` Gaussian centers with exactly
    ``per`` rows each (in random row order), ``sigma`` noise per component.
    Fixed cluster size keeps recall independent of ``n``. Returns
    ``(vectors [n, d] f32, centers)``."""
    nc = -(-n // per)
    centers = rng.standard_normal((nc, d), dtype=np.float32)
    assign = rng.permutation(nc * per)[:n] // per
    vecs = centers[assign]
    vecs += sigma * rng.standard_normal((n, d), dtype=np.float32)
    vecs *= scale
    return vecs, centers


def cluster_queries(rng, centers, q: int, *, sigma: float = 0.35,
                    scale: float = 1.0):
    """Fresh draws from random clusters, rounded through f16 (the wire
    dtype the FLAT store uploads quantized-store queries in), so the
    reference sees the exact query the device sees."""
    c = centers[rng.integers(0, len(centers), q)]
    out = (c + sigma * rng.standard_normal(c.shape, dtype=np.float32)) * scale
    return out.astype(np.float16).astype(np.float32)


# -- numpy references ----------------------------------------------------------

def _topk_rows(scores, k):
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(scores, part, 1), axis=1)
    return np.take_along_axis(part, order, 1)


def chunked_topk(score_fn, n: int, q: int, k: int = K, chunk: int = 1 << 17):
    """Top-k row ids and scores of ``score_fn(lo, hi) -> [q, hi - lo]``
    (higher is better) over ``n`` rows, in row chunks."""
    best_s = np.full((q, 0), -np.inf)
    best_i = np.zeros((q, 0), np.int64)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        s = score_fn(lo, hi)
        kk = min(k, hi - lo)
        idx = _topk_rows(s, kk)
        best_s = np.concatenate([best_s, np.take_along_axis(s, idx, 1)], 1)
        best_i = np.concatenate([best_i, idx + lo], 1)
        sel = _topk_rows(best_s, min(k, best_s.shape[1]))
        best_s = np.take_along_axis(best_s, sel, 1)
        best_i = np.take_along_axis(best_i, sel, 1)
    return best_i, best_s


def f32_truth(vecs, queries, metric: str, rows=None):
    """Ground truth on the raw f32 vectors: top-K ids (cosine or squared
    euclidean), optionally restricted to ``rows``."""
    base = vecs if rows is None else vecs[rows]
    if metric == "cosine":
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)

        def fn(lo, hi):
            b = base[lo:hi]
            return (qn @ b.T) / np.linalg.norm(b, axis=1)[None]
    else:
        qsq = np.sum(queries * queries, axis=1, keepdims=True)

        def fn(lo, hi):
            b = base[lo:hi]
            return -(qsq + np.sum(b * b, axis=1)[None] - 2 * (queries @ b.T))
    ids, _ = chunked_topk(fn, base.shape[0], queries.shape[0])
    return ids if rows is None else np.asarray(rows)[ids]


# |q * 127 / max|q| - (j + 1/2)| below this: the device's f32 division may
# be a few ulp off the correctly rounded one (XLA on the GPU), so either
# rounding of that component is an admissible int8 query
TIE = 1e-4


def _admissible_int8(q):
    """int8 codes of one query as numpy rounds them, plus the variants that
    round up to two tie components (see TIE) the other way."""
    qmax = np.max(np.abs(q))
    inv = np.float32(127.0) / qmax if qmax > 0 else np.float32(1.0)
    base = np.clip(np.round(q * inv), -127, 127)
    exact = q.astype(np.float64) * (127.0 / float(qmax) if qmax > 0 else 1.0)
    ties = np.nonzero(np.abs(np.abs(exact - np.floor(exact)) - 0.5) < TIE)[0]
    other = np.where(base == np.floor(exact), base + 1, base - 1)
    variants = [base]
    for n_flip in (1, 2):
        for flip in itertools.combinations(ties, n_flip):
            v = base.copy()
            v[list(flip)] = other[list(flip)]
            variants.append(v)
    return [np.clip(v, -127, 127).astype(np.float32) for v in variants], inv


def int8_reference(codes, scale, queries, rows=None):
    """The I8 exact scan's arithmetic, independently: per-query symmetric
    int8 quantization in f32 (one division per query, a multiply per
    element, as ops/distance.py quantize_queries_i8), exact integer dots
    (f32 GEMM of int8 values is exact: every partial sum stays below 2^24
    at D <= 1040), then the row and query scales in f64.

    Returns ``(refs, qfac)``: ``refs[r]`` lists ``(ids [K], 0-100 scores
    [K])`` for every admissible quantization of query r (see TIE), and
    ``qfac[r]`` is its query scale over its norm."""
    qrows, owner, qscale = [], [], []
    for r, q in enumerate(queries):
        variants, inv = _admissible_int8(q)
        qrows += variants
        owner += [r] * len(variants)
        qscale.append(1.0 / float(inv))
    owner = np.asarray(owner)
    qscale = np.asarray(qscale)
    qn = np.linalg.norm(queries.astype(np.float64), axis=1)
    qi = np.stack(qrows)
    fac = (qscale / np.maximum(qn, 1e-30))[owner][:, None]
    sel = np.arange(codes.shape[0]) if rows is None else np.asarray(rows)
    c_all, s_all = codes[sel], scale.reshape(-1)[sel].astype(np.float64)

    def fn(lo, hi):
        c = c_all[lo:hi].astype(np.float32)
        dots = (qi @ c.T).astype(np.float64)
        s = s_all[lo:hi]
        vn = np.sqrt(np.sum(np.square(c.astype(np.float64)), 1))
        cos = dots * fac / np.maximum(vn[None], 1e-30)  # the row scale cancels
        return (1.0 + cos) * 50.0
    ids, scores = chunked_topk(fn, len(sel), len(qi))
    refs = [[] for _ in queries]
    for v, r in enumerate(owner):
        refs[r].append((sel[ids[v]], scores[v]))
    return refs, qscale / np.maximum(qn, 1e-30)


def recall(got, truth) -> float:
    hit = sum(len(set(map(int, g)) & set(map(int, t)))
              for g, t in zip(got, truth))
    return hit / truth.size


def _exact_mismatch(got_ids, got_scores, ref_ids, ref_scores, tol):
    """None if one query's top-K matches a reference's, else why not."""
    ref = dict(zip(map(int, ref_ids), ref_scores))
    kth = ref_scores[K - 1]
    for i, s in zip(got_ids, got_scores):
        if int(i) in ref:
            if abs(s - ref[int(i)]) > tol:
                return f"id {i} score {s} vs ref {ref[int(i)]} (tol {tol})"
        elif abs(s - kth) > 2 * tol:
            return (f"returned id {i} (score {s}) not in the reference "
                    f"top-{K} (K-th score {kth})")
    return None


def check_exact_ids(got_ids, got_scores, refs, tol: float, what: str) -> None:
    """Each query's top-K ids must equal one of its references' (``refs[r]``
    lists admissible ``(ids, scores)``) except where a reference score sits
    within ``tol`` of the K-th (a near-tie); scores must agree to ``tol``."""
    for r, variants in enumerate(refs):
        why = [_exact_mismatch(got_ids[r], got_scores[r], i, s, tol)
               for i, s in variants]
        check(None in why, f"{what}: query {r}: {why[0]}")


# -- engine helpers ----------------------------------------------------------

def store_of(engine, name: str):
    """The FlatStore behind an edge collection (for its codes and
    placement); the engine keeps it in its private collection table."""
    return engine._collections[name].store


def columnar_ids(counts, pks, scores, q: int):
    """SearchBatch columnar result -> ([q, K] row ids, [q, K] scores),
    -1 / -inf where a query has fewer than K hits. Row i's key is "p<i>"."""
    ids = np.full((q, K), -1, np.int64)
    sc = np.full((q, K), -np.inf)
    pos = 0
    for r, c in enumerate(counts):
        ids[r, :c] = [int(p[1:]) for p in pks[pos:pos + c]]
        sc[r, :c] = scores[pos:pos + c]
        pos += c
    return ids, sc


def median_ms(fn, reps: int = 7) -> float:
    fn()
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


class Ctx:
    def __init__(self, args, sizes: Sizes, on_gpu: bool, workdir: str):
        self.seed = args.seed
        self.sizes = sizes
        self.on_gpu = on_gpu
        self.workdir = workdir

    def rng(self, phase: int):
        return np.random.default_rng([self.seed, phase])

    def path(self, *parts) -> str:
        p = os.path.join(self.workdir, *parts)
        os.makedirs(p, exist_ok=True)
        return p


def edge_engine(root: str, mesh=None):
    from coltt_tpu.engine.edge import EdgeEngine
    from coltt_tpu.storage.objectstore import LocalObjectStore
    from coltt_tpu.utils.config import Config

    serving = Config().serving  # the servicer's defaults (api/server.py)
    return EdgeEngine(
        LocalObjectStore(root),
        batch_max=serving.scan_batch_max,
        batch_wait_s=serving.scan_batch_wait_ms / 1e3,
        pq_opq_iters=serving.pq_opq_iters,
        mesh=mesh,
        precompile_batches=tuple(
            int(b) for b in serving.precompile_batches.split(",")),
    )


def edge_schema(name: str, dim: int, quant, metric):
    from coltt_tpu.index.schema import CollectionSchema, FieldSchema, FieldType

    return CollectionSchema(
        name=name, dim=dim, metric=metric, quantization=quant,
        fields=[FieldSchema("pk", FieldType.STRING, primary_key=True),
                FieldSchema("tag", FieldType.STRING)],
    )


def tags_for(n: int):
    """'rare' on every 1000th row (the gather regime), else one of four
    common tags (the masked-scan regime)."""
    return ["rare" if i % 1000 == 0 else f"c{i % 4}" for i in range(n)]


def ingest_edge(eng, name, vecs, tags):
    mds = [{"pk": f"p{i}", "tag": t} for i, t in enumerate(tags)]
    eng.index_many(name, mds, vecs)


# -- phases ---------------------------------------------------------------------

def phase_edge_flat(ctx: Ctx, quant_name: str, mesh=None, n=None) -> dict:
    """Edge FLAT at deployment size: lifecycle, exact and fused search
    against the numpy references, filtered search, upsert and delete."""
    import jax
    import jax.numpy as jnp
    from coltt_tpu.index.filter import Filter, Op
    from coltt_tpu.ops import scan_pallas
    from coltt_tpu.ops.distance import Metric
    from coltt_tpu.ops.quant import Quantization

    quant = Quantization[quant_name.upper()]
    metric = "cosine" if quant == Quantization.I8 else "euclidean"
    scale = 1.0 if metric == "cosine" else 0.25  # keeps L2 scores in (0, 100)
    n = n or ctx.sizes.flat_n
    d = ctx.sizes.dim
    rng = ctx.rng(1 if quant == Quantization.I8 else 2)
    vecs, centers = cluster_corpus(rng, n, d, scale=scale)
    qmax = max(ctx.sizes.batches)
    queries = cluster_queries(rng, centers, qmax, scale=scale)
    tags = tags_for(n)
    name = f"flat_{quant_name}"
    eng = edge_engine(ctx.path(name), mesh=mesh)
    eng.create_collection(edge_schema(name, d, quant, Metric.parse(metric)))
    ingest_edge(eng, name, vecs, tags)
    if mesh is None:
        eng.flush(name)
        eng.release_collection(name)
        eng.load_collection(name)  # runs the precompile, fused kernel included
    eng.search_batch(name, queries[:1], limit=K)  # applies staged rows
    store = store_of(eng, name)
    check(all(store.pk_to_slot[f"p{i}"] == i for i in (0, 1, n // 2, n - 1)),
          "rows were not assigned slots in ingest order")
    out = {}

    truth = f32_truth(vecs, queries[:NREF], metric)
    host_codes = np.asarray(jax.device_get(store.codes))[:n]
    host_scale = np.asarray(jax.device_get(store.scale))[:n]
    if quant == Quantization.I8:
        refs, qfac = int8_reference(host_codes, host_scale, queries[:NREF])
        exact_tol = 2e-4  # 0-100 score units: f32 rounding of the epilogue
        # fused packing: key low 5 bits dropped, |err| < 2^-17 * B with
        # B = 2 * 127 * sqrt(d); in score units x qscale/|q| x 50
        fused_tol = 50.0 * 2.0 ** -17 * 2 * 127 * np.sqrt(d) * qfac + exact_tol
    else:
        deq = host_codes.astype(np.float32) * host_scale
        qsq = np.sum(queries[:NREF].astype(np.float64) ** 2, 1, keepdims=True)

        def fn(lo, hi):
            b = deq[lo:hi].astype(np.float64)
            dist = qsq + np.sum(b * b, 1)[None] - 2 * (
                queries[:NREF].astype(np.float64) @ b.T)
            return np.maximum(0.0, 100.0 - dist)
        ref_ids, ref_scores = chunked_topk(fn, n, NREF)
        refs = [[(i, sc)] for i, sc in zip(ref_ids, ref_scores)]
        f8_tol = 1e-2 * float(np.abs(ref_scores).max())
        del deq
    results = {}
    for q in ctx.sizes.batches:
        for hr in (False, True):
            counts, scores, pks, _ = eng.search_batch(
                name, queries[:q], limit=K, high_resource=hr)
            ids, sc = columnar_ids(counts, pks, scores, q)
            check((np.asarray(counts) == K).all(), f"Q={q} hr={hr}: short results")
            results[(q, hr)] = (ids, sc)
        (ex_ids, ex_sc), (fu_ids, fu_sc) = results[(q, False)], results[(q, True)]
        m = min(q, NREF)
        if quant == Quantization.I8:
            check_exact_ids(ex_ids[:m], ex_sc[:m], refs[:m], exact_tol,
                            f"I8 exact Q={q}")
        else:  # bf16 compute: scores agree to 1e-2 relative
            check_exact_ids(ex_ids[:m], ex_sc[:m], refs[:m], f8_tol,
                            f"F8 exact Q={q}")
        ov = recall(fu_ids, ex_ids)
        out[f"fused_overlap_q{q}"] = ov
        check(ov >= 0.98, f"fused vs exact overlap {ov} < 0.98 at Q={q}")
        for r in range(q):
            shared = {int(i): s for i, s in zip(ex_ids[r], ex_sc[r])}
            for i, s in zip(fu_ids[r], fu_sc[r]):
                if int(i) not in shared:
                    continue
                if quant == Quantization.I8:
                    tol = fused_tol[r] if r < NREF else fused_tol.max()
                else:
                    tol = 1e-2 * abs(shared[int(i)]) + 1e-3
                check(abs(s - shared[int(i)]) <= tol,
                      f"fused score {s} vs exact {shared[int(i)]} (tol {tol})")
        if q >= NREF:
            out[f"recall_exact_q{q}"] = recall(ex_ids[:NREF], truth)
            out[f"recall_fused_q{q}"] = recall(fu_ids[:NREF], truth)
    out["recall"] = min(v for k_, v in out.items() if k_.startswith("recall_"))
    check(out["recall"] >= FLOORS[quant_name],
          f"recall {out['recall']} below floor {FLOORS[quant_name]}")

    # filtered search in both regimes, exact and fused
    tag_arr = np.asarray(tags)
    for tag in ("rare", "c1"):
        rows = np.nonzero(tag_arr == tag)[0]
        flt = Filter("tag", Op.EQ, tag)
        ftruth = f32_truth(vecs, queries[:NREF], metric, rows=rows)
        for hr in (False, True):
            counts, scores, pks, _ = eng.search_batch(
                name, queries[:NREF], limit=K, filter_expression=flt,
                high_resource=hr)
            ids, _ = columnar_ids(counts, pks, scores, NREF)
            check(np.isin(ids[ids >= 0], rows).all(),
                  f"filter {tag}: returned a row without the tag")
            out[f"recall_filter_{tag}_{'fused' if hr else 'exact'}"] = recall(
                ids, ftruth)
        if quant == Quantization.I8 and tag == "rare":
            rrefs, _ = int8_reference(host_codes, host_scale,
                                      queries[:NREF], rows=rows)
            counts, scores, pks, _ = eng.search_batch(
                name, queries[:NREF], limit=K, filter_expression=flt)
            ids, sc = columnar_ids(counts, pks, scores, NREF)
            check_exact_ids(ids, sc, rrefs, exact_tol, "I8 filtered rare")

    # an upsert and a delete, each seen by the next search
    target = queries[0]
    eng.index(name, {"pk": "p5", "tag": "c1"}, vector=target)
    hits = eng.search(name, target, limit=K)
    check(hits[0].id == "p5", f"upsert not seen: top hit {hits[0].id}")
    victim = hits[1].id
    eng.index(name, {"pk": victim}, delete=True)
    for hr in (False, True):
        hits = eng.search(name, target, limit=K, high_resource=hr)
        check(victim not in [h.id for h in hits],
              f"deleted row {victim} still returned (hr={hr})")
        check(hits[0].id == "p5", "upserted row lost after the delete")

    if ctx.on_gpu:  # a CPU run's times say nothing about the device
        # fused kernel vs the XLA scan, end to end through the engine
        for q in (64, max(ctx.sizes.batches)):
            for hr in (False, True):
                ms = median_ms(lambda: eng.search_batch(
                    name, queries[:q], limit=K, high_resource=hr))
                out[f"ms_q{q}_{'fused' if hr else 'xla'}"] = round(ms, 3)

    if ctx.on_gpu and mesh is None:
        from coltt_tpu.ops.scan_pallas import fused_scan_topk
        from functools import partial

        sd = jax.ShapeDtypeStruct
        txt = jax.jit(partial(fused_scan_topk, k=K, metric=Metric.parse(metric))).lower(
            sd((64, d), jnp.float32), store.codes, store.scale, store.sqnorm,
            store.valid).compile().as_text()
        has_call = ("__gpu$xla.gpu.triton" in txt
                    and scan_pallas.KERNEL_NAME in txt)
        out["fused_triton_custom_call"] = has_call
        check(has_call, "compiled fused search has no Triton kernel call")
    if mesh is not None:
        devs = store.codes.sharding.device_set
        out["shard_devices"] = len(devs)
        check(len(devs) == mesh.size, f"codes on {len(devs)} devices, "
              f"mesh has {mesh.size}")
    eng.delete_collection(name)
    return out


def phase_edge_pq_bq(ctx: Ctx) -> dict:
    """Edge PQ and BQ through the same engine: create, index, search,
    reload, search again (same ids)."""
    from coltt_tpu.ops.distance import Metric
    from coltt_tpu.ops.quant import Quantization

    n, d = ctx.sizes.pqbq_n, ctx.sizes.dim
    rng = ctx.rng(3)
    vecs, centers = cluster_corpus(rng, n, d)
    queries = cluster_queries(rng, centers, NREF)
    truth = f32_truth(vecs, queries, "cosine")
    out = {}
    for quant in (Quantization.PQ, Quantization.BQ):
        name = f"edge_{quant.name.lower()}"
        eng = edge_engine(ctx.path(name))
        eng.create_collection(edge_schema(name, d, quant, Metric.COSINE))
        ingest_edge(eng, name, vecs, tags_for(n))
        got = {}
        for hr in (False, True):
            counts, scores, pks, _ = eng.search_batch(
                name, queries, limit=K, high_resource=hr)
            got[hr] = columnar_ids(counts, pks, scores, NREF)[0]
        eng.release_collection(name)
        eng.load_collection(name)
        counts, scores, pks, _ = eng.search_batch(name, queries, limit=K)
        again = columnar_ids(counts, pks, scores, NREF)[0]
        check(recall(again, got[False]) >= 0.99,
              f"{quant.name}: results changed across reload")
        key = quant.name.lower()
        out[f"recall_{key}"] = recall(got[False], truth)
        out[f"recall_{key}_hr"] = recall(got[True], truth)
        check(min(out[f"recall_{key}"], out[f"recall_{key}_hr"]) >= FLOORS[key],
              f"{quant.name} recall {out[f'recall_{key}']} below floor")
        eng.delete_collection(name)
    out["recall"] = min(out["recall_pq"], out["recall_bq"])
    return out


def phase_core_hnsw(ctx: Ctx) -> dict:
    """Core (HNSW): bulk_insert, search, close, reopen from the graph
    snapshot, search; then inserts and a delete, an unclean stop, and a
    reopen that replays the write-ahead log."""
    from coltt_tpu.engine.core import CollectionSpec, CoreEngine

    n, d = ctx.sizes.hnsw_n, ctx.sizes.hnsw_dim
    rng = ctx.rng(4)
    vecs, centers = cluster_corpus(rng, n, d)
    queries = cluster_queries(rng, centers, NREF)
    truth = f32_truth(vecs, queries, "cosine")
    data = ctx.path("core")

    def search(e):
        counts, scores, ids, _ = e.vector_search_batch(
            "h", queries, top_k=K, ef=HNSW_EF)
        return columnar_ids(counts, ids, scores, NREF)[0]

    e1 = CoreEngine(data)
    e1.create_collection(CollectionSpec(name="h", dim=d))
    e1.bulk_insert("h", vecs, [{"i": i} for i in range(n)],
                   ext_ids=[f"p{i}" for i in range(n)])
    first = search(e1)
    e1.close()
    e2 = CoreEngine(data)
    e2.load_collection("h")
    snap = search(e2)
    out = {"recall": recall(first, truth), "recall_snapshot": recall(snap, truth)}
    check(recall(snap, first) >= 0.99, "results changed across the snapshot")
    # write-ahead log: new rows and a delete, then an unclean stop
    extra = cluster_queries(rng, centers, 8)
    for j, v in enumerate(extra):
        e2.insert("h", v, {"i": n + j}, ext_id=f"p{n + j}")
    victim = f"p{int(first[0][0])}"
    e2.delete("h", victim)
    e2.kv.close()  # no snapshot: the next load replays the log
    e3 = CoreEngine(data)
    info = e3.load_collection("h")
    check(info["size"] == n + len(extra) - 1,
          f"log replay restored {info['size']} rows")
    hits = e3.vector_search("h", extra[3], top_k=1)
    check(hits[0].id == f"p{n + 3}", f"replayed insert not found: {hits[0].id}")
    replay = search(e3)
    check(victim not in {f"p{i}" for i in replay[0]}, "replayed delete lost")
    out["recall_replay"] = recall(replay, truth)
    e3.close()
    check(min(out.values()) >= FLOORS["hnsw"],
          f"HNSW recall {min(out.values())} below floor")
    return out


def phase_cflat(ctx: Ctx) -> dict:
    """Experimental CFLAT: two vector fields weighted 70/30 against a
    numpy reference of the same weighted 0-100 score."""
    from coltt_tpu.engine.experimental import ExperimentalEngine
    from coltt_tpu.index.schema import CollectionSchema, FieldSchema, FieldType
    from coltt_tpu.storage.objectstore import LocalObjectStore

    n, d = ctx.sizes.cflat_n, ctx.sizes.dim
    rng = ctx.rng(5)
    body, cb = cluster_corpus(rng, n, d)
    title, ct = cluster_corpus(rng, n, d)
    qb = cluster_queries(rng, cb, 16)
    qt = cluster_queries(rng, ct, 16)
    eng = ExperimentalEngine(LocalObjectStore(ctx.path("cflat")))
    eng.create_collection(CollectionSchema(
        name="mv", dim=d,
        fields=[FieldSchema("body", FieldType.VECTOR),
                FieldSchema("title", FieldType.VECTOR),
                FieldSchema("lang", FieldType.STRING, enable_null=True)]))
    eng.index_many("mv", [f"p{i}" for i in range(n)],
                   {"body": body, "title": title})

    def cos(qs, vs):
        qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
        return (qn @ vs.T) / np.linalg.norm(vs, axis=1)[None]
    ref = 0.7 * (1 + cos(qb, body)) * 50 + 0.3 * (1 + cos(qt, title)) * 50
    truth = _topk_rows(ref, K)
    got = np.full((16, K), -1)
    for r in range(16):
        hits = eng.vector_search(
            "mv", [("body", qb[r], True, 70.0), ("title", qt[r], True, 30.0)],
            top_k=K)
        got[r, :len(hits)] = [int(h.id[1:]) for h in hits]
        check(abs(hits[0].score - ref[r, truth[r, 0]]) <= 1e-3,
              f"CFLAT top score {hits[0].score} vs {ref[r, truth[r, 0]]}")
    out = {"recall": recall(got, truth)}
    check(out["recall"] >= FLOORS["cflat"], f"CFLAT recall {out['recall']}")
    eng.delete_collection("mv")
    return out


def phase_served(ctx: Ctx) -> dict:
    """An edge gRPC server in this process, driven by EdgeClient from a
    thread: bulk index, Search and SearchBatch, against the engine."""
    import grpc

    from coltt_tpu.api.client import EdgeClient
    from coltt_tpu.api.server import build_servicer, create_server
    from coltt_tpu.ops.distance import Metric
    from coltt_tpu.ops.quant import Quantization
    from coltt_tpu.utils.config import Config

    n, d = ctx.sizes.served_n, ctx.sizes.dim
    rng = ctx.rng(6)
    vecs, centers = cluster_corpus(rng, n, d)
    queries = cluster_queries(rng, centers, NREF)
    truth = f32_truth(vecs, queries, "cosine")
    cfg = Config()
    cfg.root_layer.bind_address = "127.0.0.1:0"
    cfg.storage.data_dir = ctx.path("served", "data")
    cfg.storage.object_store_root = ctx.path("served", "objects")
    servicer = build_servicer("edge", cfg)
    server = create_server(servicer, cfg)
    server.start()
    out, errors = {}, []

    def client():
        try:
            with grpc.insecure_channel(
                    f"127.0.0.1:{server.bound_port}") as channel:
                c = EdgeClient(channel)
                c.create_collection(edge_schema("srv", d, Quantization.I8,
                                                Metric.COSINE))
                for lo in range(0, n, 2048):
                    hi = min(n, lo + 2048)
                    c.bulk_index("srv", [f"p{i}" for i in range(lo, hi)],
                                 vecs[lo:hi],
                                 [{"tag": t} for t in tags_for(n)[lo:hi]])
                counts, scores, pks, _ = c.search_batch("srv", queries, limit=K)
                out["batch"] = columnar_ids(counts, pks, scores, NREF)[0]
                out["single"] = [
                    [int(h["id"][1:]) for h in c.search("srv", queries[r], limit=K,
                                                        high_resource=hr)]
                    for r, hr in ((0, False), (1, True), (2, False))
                ]
        except Exception as e:  # reported by the main thread below
            errors.append(e)

    t = threading.Thread(target=client)
    t.start()
    t.join(timeout=600)
    check(not t.is_alive(), "gRPC client thread did not finish")
    server.stop(None).wait(timeout=30)
    if errors:
        raise errors[0]
    counts, scores, pks, _ = servicer.engine.search_batch("srv", queries, limit=K)
    direct = columnar_ids(counts, pks, scores, NREF)[0]
    check((out["batch"] == direct).all(), "SearchBatch RPC != engine results")
    check(out["single"][0] == list(direct[0]), "Search RPC != engine results")
    res = {"recall": recall(out["batch"], truth)}
    check(res["recall"] >= FLOORS["served"], f"served recall {res['recall']}")
    servicer.engine.delete_collection("srv")
    return res


def phase_sharded(ctx: Ctx) -> dict:
    """Edge I8 over a 4-device mesh ([serving].shards = 4)."""
    import jax
    from coltt_tpu.parallel.mesh import make_mesh

    check(len(jax.devices()) >= 4, f"--chips 4 needs 4 devices, "
          f"have {len(jax.devices())}")
    return phase_edge_flat(ctx, "i8", mesh=make_mesh(4),
                           n=ctx.sizes.sharded_n)


# -- driver ----------------------------------------------------------------------

def gpu_lines():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return res.stdout.strip().splitlines() or ["not reported"]
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable: {e}"]


def run_phase(label, fn, counter):
    before = counter.snapshot()
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    after = counter.snapshot()
    hits = after["hits"] - before["hits"]
    misses = after["misses"] - before["misses"]
    shown = {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in res.items()}
    print(f"phase {label}: ok wall={wall:.1f}s cache_hits={hits} "
          f"cache_misses={misses} recall@10={res['recall']:.4f} "
          f"{json.dumps(shown, sort_keys=True)}", flush=True)
    gc.collect()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4: run only the sharded edge phase on 4 GPUs")
    p.add_argument("--small", action="store_true",
                   help="reduced sizes (the CPU rehearsal)")
    p.add_argument("--allow-cpu", action="store_true",
                   help="with --small: run without a GPU (rehearsal only)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.allow_cpu and not args.small:
        print("--allow-cpu is only for the --small rehearsal", file=sys.stderr)
        return 2
    import jax

    dev = jax.devices()[0]
    on_gpu = dev.platform == "gpu"
    if not on_gpu and not args.allow_cpu:
        print(f"no GPU: JAX platform is {dev.platform!r}", file=sys.stderr)
        return 1
    from coltt_tpu import native
    from coltt_tpu.utils.compile_cache import CacheCounter, configure_compile_cache

    cache_dir = configure_compile_cache()
    counter = CacheCounter()
    for line in gpu_lines():  # name, power limit: as nvidia-smi prints them
        print(line, flush=True)
    print(f"native WAL library loaded: {native.available()}", flush=True)
    print(f"jax {jax.__version__} devices={len(jax.devices())} "
          f"kind={dev.device_kind} compile_cache={cache_dir}", flush=True)
    sizes = SMALL if args.small else FULL
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    ctx = Ctx(args, sizes, on_gpu, workdir)
    try:
        if args.chips == 4:
            run_phase("edge_sharded_i8_4dev", lambda: phase_sharded(ctx), counter)
        else:
            run_phase("edge_flat_i8", lambda: phase_edge_flat(ctx, "i8"), counter)
            run_phase("edge_flat_f8", lambda: phase_edge_flat(ctx, "f8"), counter)
            run_phase("edge_pq_bq", lambda: phase_edge_pq_bq(ctx), counter)
            run_phase("core_hnsw", lambda: phase_core_hnsw(ctx), counter)
            run_phase("experimental_cflat", lambda: phase_cflat(ctx), counter)
            run_phase("served_grpc_edge", lambda: phase_served(ctx), counter)
    finally:
        counter.close()
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
