"""FLAT serving benchmark: QPS at recall@10, 1M x 768d, quantized scan.

BASELINE.json headline config #2, measured as production serving would run:
continuous query batching (pipelined dispatches, results fetched as they
complete). Prints exactly ONE JSON line to stdout, naming the device it
ran on.

Methodology: recall on a dedicated 4096-query sample (independent of the
pipeline depth); QPS = median of 5 pipelined rounds after 2 discarded warm
rounds, pipeline depth 16. The serving configuration is the fused int8
kernel (ops/scan_pallas.py) with the "approx" selection and a bf16 rerank
of the k*4 shortlist.

Baseline anchor: the reference's best published FLAT latency is 0.02-0.03 s
per query on 1M x 128d with 16 goroutines (UPDATE-LOG.md:107 / BASELINE.md)
=> ~40 QPS. This bench runs 6x the per-query FLOPs (768d);
vs_baseline = our QPS / 40. The corpus is i.i.d. Gaussian, which makes
this a throughput number only: chip_smoke.py holds recall on
cluster-mixture data.
"""

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from coltt_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax.numpy as jnp

    from coltt_tpu.ops.distance import Metric
    from coltt_tpu.ops.quant import Quantization
    from coltt_tpu.ops.topk import compute_recall
    from coltt_tpu.parallel.dist_search import (
        DistributedFlatIndex, sharded_scan_topk,
    )
    from coltt_tpu.parallel.mesh import BATCH_AXIS, make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    n, d, k = 1_000_000, 768, 10
    batch = 2048  # the kernel's cost is near-flat in Q up to here
    depth = 16    # pipelined dispatches per measurement
    final = "approx"
    recall_q = 4096  # dedicated query sample, independent of `depth`; two
    # 2048-query searches reuse the timing batches' compiled shape

    log(f"devices: {jax.devices()}")
    t0 = time.perf_counter()
    kv, kq = jax.random.split(jax.random.PRNGKey(0))
    vecs = jax.random.normal(kv, (n, d), jnp.float32)
    jax.block_until_ready(vecs)
    log(f"data gen (on device): {time.perf_counter()-t0:.1f}s")

    mesh = make_mesh(num_shards=len(jax.devices()), batch=1)
    qspec = NamedSharding(mesh, P(BATCH_AXIS))
    t0 = time.perf_counter()
    idx = DistributedFlatIndex(mesh, vecs, metric=Metric.COSINE,
                               quantization=Quantization.I8,
                               rerank_dtype=jnp.bfloat16)
    log(f"ingest+quantize 1M x 768 i8 (+bf16 rerank copy): {time.perf_counter()-t0:.1f}s")

    # serving scan: the Pallas fused kernel (ops/scan_pallas.py) — int8
    # tensor-core dot, in-register bin selection (one packed survivor per
    # 32 rows, no [Q, N] score matrix in device memory), the "approx"
    # selection over the survivors, then a bf16 rerank of the k*4
    # shortlist (storage error, not selection, is the recall ceiling).
    def dispatch(q_dev):
        return sharded_scan_topk(
            mesh, idx.codes, idx.scale, idx.sqnorm, idx.valid, q_dev,
            k=k, metric=idx.metric, compute_dtype=idx.compute_dtype,
            fused=True, final=final,
            rr_codes=idx.rr_codes, oversample=4,
        )

    qkeys = jax.random.split(kq, depth)
    q_batches = [
        jax.device_put(jax.random.normal(qk, (batch, d), jnp.float32), qspec)
        for qk in qkeys
    ]
    jax.block_until_ready(q_batches)

    # warmup / compile (recorded in the artifact)
    t0 = time.perf_counter()
    np.asarray(dispatch(q_batches[0])[0])
    warmup_s = time.perf_counter() - t0
    log(f"warmup (compile): {warmup_s:.1f}s")

    # p50 latency: synchronous single batches
    lats = []
    for i in range(5):
        t0 = time.perf_counter()
        np.asarray(dispatch(q_batches[i % depth])[0])
        lats.append(time.perf_counter() - t0)
    p50_batch_ms = float(np.median(lats) * 1e3)

    # throughput: pipelined (continuous query batching), median of 5 rounds
    # after 2 discarded warm rounds. Dispatches queue on the device
    # back-to-back; results are fetched on a thread pool so each fetch
    # overlaps with compute instead of serializing.
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(depth)
    qps_rounds = []
    for r in range(7):
        t0 = time.perf_counter()
        outs = [dispatch(q_batches[i]) for i in range(depth)]
        futs = [pool.submit(lambda o=o: np.asarray(o[0])) for o in outs]
        for f in futs:
            f.result()
        dt = time.perf_counter() - t0
        if r >= 2:
            qps_rounds.append(depth * batch / dt)
    qps = float(np.median(qps_rounds))
    log(f"p50 sync batch latency: {p50_batch_ms:.2f} ms; pipelined QPS "
        f"median-of-5: {qps:.0f} (rounds {[round(x) for x in qps_rounds]})")

    # recall@10 vs fp32 ground truth (exact scan on-device, f32) on a
    # dedicated 4096-query sample (two 2048-query searches — the same
    # compiled serving shape as the timing batches)
    gt_idx = DistributedFlatIndex(mesh, vecs, metric=Metric.COSINE,
                                  quantization=Quantization.NONE)
    rkey = jax.random.fold_in(kq, 0x5eca11)
    gq = np.asarray(jax.device_get(
        jax.random.normal(rkey, (recall_q, d), jnp.float32)
    ))
    got, truth = [], []
    for i in range(0, recall_q, batch):
        _, gt_ids = gt_idx.search(gq[i:i + batch], k)
        _, i8_ids = idx.search(gq[i:i + batch], k, fused=True,
                               oversample=4, final=final)
        truth.append(gt_ids)
        got.append(i8_ids)
    recall = float(compute_recall(np.concatenate(got), np.concatenate(truth)))
    log(f"recall@10 vs fp32 ({recall_q} queries): {recall:.4f}")

    baseline_qps = 40.0  # 1/0.025s, reference highCpu FLAT (BASELINE.md)
    print(json.dumps({
        "metric": "FLAT fused-i8+bf16-rerank QPS/device at recall@10 "
                  "(1M x 768d, batch=2048, pipelined depth=16, "
                  "median-of-5)",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / baseline_qps, 2),
        "recall_at_10": round(recall, 4),
        "recall_queries": recall_q,
        "qps_rounds": [round(x, 1) for x in qps_rounds],
        "p50_batch_latency_ms": round(p50_batch_ms, 3),
        "p50_query_latency_ms": round(p50_batch_ms / batch, 4),
        "warmup_s": round(warmup_s, 1),
        "final": final,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
