"""BASELINE config #5: CFLAT weighted multi-vector search, 1M records.

Each record carries two named vectors (a 768d "semantic" field and a
256d "title" field); the query scores Σ ratio_f * normalize(dist_f) in
one fused pass per field with a single top-k over the weighted sum —
the batched-device version of the reference's shard-goroutine CFLAT
(experimental/multi_vector_vertex.go:85-138, always-parallel).

Reference anchor: the reference publishes no CFLAT latency; its FLAT
anchor (20-30 ms/query at 1M x 128d) is the nearest published number,
and CFLAT here does ~7.9x those FLOPs (768+256 dims, two scans).

Prints ONE JSON line (secondary bench; the driver's headline stays
bench.py). Run on the GPU:  timeout 3600 python -u bench_cflat.py
"""

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import os

    import jax

    from coltt_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coltt_tpu.ops.distance import Metric
    from coltt_tpu.ops.quant import Quantization, dequantize, quantize, storage_dtype
    from coltt_tpu.parallel.dist_search import sharded_cflat_topk
    from coltt_tpu.parallel.mesh import BATCH_AXIS, make_mesh

    n, k = 1 << 20, 10
    dims = (768, 256)
    ratios = (0.7, 0.3)
    batch = 512
    depth = 8

    log(f"devices: {jax.devices()}")
    mesh = make_mesh(num_shards=len(jax.devices()), batch=1)
    shard = NamedSharding(mesh, P("shard"))
    qspec = NamedSharding(mesh, P(BATCH_AXIS))

    key = jax.random.PRNGKey(0)
    field_state = []
    fulls = []
    for d in dims:
        kf, key = jax.random.split(key)
        vecs = jax.random.normal(kf, (n, d), jnp.float32)
        codes, scale = quantize(vecs, Quantization.F8)
        codes = codes.astype(storage_dtype(Quantization.F8))
        deq = dequantize(codes, scale)
        sqn = jnp.sum(deq * deq, axis=1)
        field_state.append((
            jax.device_put(codes, shard),
            jax.device_put(scale, shard),
            jax.device_put(sqn, shard),
        ))
        fulls.append(vecs)
    valid = jax.device_put(jnp.ones(n, bool), shard)
    jax.block_until_ready(field_state)

    def mk_queries(kq, m):
        qs = []
        for d in dims:
            kq, sub = jax.random.split(kq)
            qs.append(jax.device_put(
                jax.random.normal(sub, (m, d), jnp.float32), qspec))
        return tuple(qs)

    jr = [jnp.float32(r) for r in ratios]

    def dispatch(qs):
        return sharded_cflat_topk(
            mesh, tuple(field_state), valid, qs, tuple(jr),
            k=k, metric=Metric.COSINE,
        )

    kq, key = jax.random.split(key)
    q_batches = [mk_queries(jax.random.fold_in(kq, i), batch)
                 for i in range(depth)]
    jax.block_until_ready(q_batches)

    t0 = time.perf_counter()
    np.asarray(dispatch(q_batches[0])[0])
    log(f"warmup (compile): {time.perf_counter()-t0:.1f}s")

    best = 0.0
    lats = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [dispatch(q_batches[i]) for i in range(depth)]
        total = sum(o[0].sum() for o in outs)
        np.asarray(total)
        dt = time.perf_counter() - t0
        best = max(best, depth * batch / dt)
        lats.append(dt / depth)
    p50 = float(np.median(lats) * 1e3)

    # weighted-sum ground truth in f32 on 64 eval queries
    eval_q = mk_queries(jax.random.fold_in(kq, 999), 64)
    from coltt_tpu.ops.distance import scan_distances
    from coltt_tpu.ops.score import normalize_score
    total = None
    for (vecs, q, r) in zip(fulls, eval_q, ratios):
        sqn = jnp.sum(vecs * vecs, axis=1)
        dist = scan_distances(q, vecs, None, sqnorm=sqn, valid=None,
                              metric=Metric.COSINE, compute_dtype=jnp.float32)
        contrib = normalize_score(dist, Metric.COSINE) * r
        total = contrib if total is None else total + contrib
    _, gt = jax.lax.top_k(total, k)
    gt = np.asarray(gt)
    _, got = dispatch(eval_q)
    got = np.asarray(got)[:64]
    recall = float(np.mean([len(set(gt[i]) & set(got[i])) / k
                            for i in range(64)]))
    log(f"QPS {best:.0f}; p50 batch {p50:.1f} ms; recall@10 vs f32 {recall:.3f}")

    print(json.dumps({
        "metric": "CFLAT 2-field weighted search QPS/chip at recall@10 "
                  "(1M x (768+256)d f8, batch=512)",
        "value": round(best, 1),
        "unit": "qps",
        "vs_baseline": round(best / 40.0, 2),  # reference FLAT anchor
        "recall_at_10": round(recall, 4),
        "p50_batch_latency_ms": round(p50, 3),
        "devices": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
