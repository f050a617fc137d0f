"""BASELINE config #3: HNSW graph search, 1M vectors, bf16, batched queries.

Reference anchor: 0.87 ms/query on 1M x 128d, single query at a time
(UPDATE-LOG.md:142) => ~1150 QPS. Here the graph is built on device with
``bulk_build_clustered`` (k-means blocks + heuristic select, the matmul
ingest path; ``--beam`` selects the older gather-bound beam builder) and
searched with the batched beam kernel (bf16 vectors).

Prints ONE JSON line (secondary bench; the driver's headline stays bench.py).
Run on the GPU:  timeout 5400 python -u bench_hnsw.py
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

    from coltt_tpu.ops.distance import Metric, scan_distances
    from coltt_tpu.ops.topk import compute_recall
    from coltt_tpu.store.hnsw import HnswConfig, HnswIndex

    n, d, k = 1_000_000, 128, 10
    if "--dim" in sys.argv:  # r5: the flagship shape is 768d (VERDICT #3)
        d = int(sys.argv[sys.argv.index("--dim") + 1])
    batch = 512
    depth = 8
    n_eval = 1024  # r04: recall std at p~0.9 over 1024*10 pairs ~ 0.003

    log(f"devices: {jax.devices()}")
    rng = np.random.default_rng(0)
    # embedding-like corpus: a cluster mixture, not raw gaussians. Pure
    # i.i.d. gaussian corpora concentrate distances at high dim — graph
    # methods (any implementation) then need ef≈512 for recall≥0.9
    # (measured: ef=64 gives .63@65k / .06@1M here, ef=512 gives .97@65k)
    # — and no real embedding workload looks like that. The reference
    # never measured recall at all (its benchmarks report latency only,
    # over random vectors). We hold ourselves to recall≥0.9 on realistic
    # structure: 16k centers x ~61 points, sigma 0.35.
    nc = 16384
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    asg = rng.integers(0, nc, n)
    vecs = (centers[asg] + 0.35 * rng.standard_normal((n, d))).astype(
        np.float32)

    beam = "--beam" in sys.argv
    descent = 0
    if "--descent" in sys.argv:
        descent = int(sys.argv[sys.argv.index("--descent") + 1])
    refine_ef = 0
    if "--refine" in sys.argv:  # clustered + one beam-refinement round
        refine_ef = int(sys.argv[sys.argv.index("--refine") + 1])
    idx = HnswIndex(d, metric=Metric.COSINE,
                    config=HnswConfig(m=16, ef_construction=100, ef=128,
                                      algorithm="heuristic"),
                    device_dtype=jnp.bfloat16)
    t0 = time.perf_counter()
    if beam:
        idx.bulk_build(vecs, refine_rounds=1, batch_rows=4096)
    else:
        idx.bulk_build_clustered(vecs, descent_rounds=descent)
        if refine_ef:
            idx.beam_refine(rounds=1, ef=refine_ef, batch_rows=4096)
    build_s = time.perf_counter() - t0
    builder = ("bulk_build(beam)" if beam
               else f"bulk_build_clustered(descent={descent}"
                    + (f",refine_ef={refine_ef}" if refine_ef else "") + ")")
    log(f"{builder} 1M x {d}d: {build_s:.1f}s "
        f"({n/build_s:.0f} inserts/s; reference one-by-one: ~1.7k/s)")

    def mk_queries(m):
        c = centers[rng.integers(0, nc, m)]
        return (c + 0.35 * rng.standard_normal((m, d))).astype(np.float32)

    eval_q = mk_queries(n_eval)
    q_batches = [mk_queries(batch) for _ in range(depth)]

    # ground truth: exact device scan
    jv = jnp.asarray(vecs)
    sqn = jnp.sum(jv * jv, axis=1)
    dist = scan_distances(jnp.asarray(eval_q), jv, None, sqnorm=sqn,
                          metric=Metric.COSINE, compute_dtype=jnp.float32)
    _, gt = jax.lax.top_k(-dist, k)
    gt = np.asarray(gt)
    del jv, dist

    t0 = time.perf_counter()
    idx.search(q_batches[0], k)
    log(f"warmup (compile): {time.perf_counter()-t0:.1f}s")

    qps_rounds, lats = [], []
    for r in range(7):
        t0 = time.perf_counter()
        for i in range(depth):
            idx.search(q_batches[i], k)
        dt = time.perf_counter() - t0
        if r >= 2:  # r04: median-of-5 after 2 warm rounds (was best-of-3)
            qps_rounds.append(depth * batch / dt)
            lats.append(dt / depth)
    best_qps = float(np.median(qps_rounds))
    p50_batch_ms = float(np.median(lats) * 1e3)

    _, ids = idx.search(eval_q, k)
    recall = compute_recall(ids, gt)
    log(f"p50 batch latency {p50_batch_ms:.2f} ms; QPS {best_qps:.0f}; "
        f"recall@10 {recall:.3f}")

    # recall frontier (VERDICT r4 #3): sweep serving ef on the SAME graph,
    # recording recall/QPS per point — where (if anywhere) recall >= .99
    # is reachable, and what it costs
    ef_sweep = None
    if "--efsweep" in sys.argv:
        ef_sweep = {}
        for ef in (64, 128, 256, 512):
            t0 = time.perf_counter()
            idx.search(q_batches[0], k, ef=ef)
            log(f"ef={ef} warmup: {time.perf_counter()-t0:.1f}s")
            rounds = []
            for r in range(7):
                t0 = time.perf_counter()
                for i in range(depth):
                    idx.search(q_batches[i], k, ef=ef)
                dt = time.perf_counter() - t0
                if r >= 2:
                    rounds.append(depth * batch / dt)
            _, ids = idx.search(eval_q, k, ef=ef)
            rec_ef = float(compute_recall(ids, gt))
            qps_ef = float(np.median(rounds))
            log(f"ef={ef}: {qps_ef:.0f} QPS, recall@10 {rec_ef:.4f}")
            ef_sweep[ef] = {"qps": round(qps_ef, 1),
                            "recall_at_10": round(rec_ef, 4)}

    # interleaved mutate/search (VERDICT r3 item 4b): search QPS while a
    # writer thread inserts/removes — exercises the dirty-row scatter
    # update of the capacity-shaped device cache (a full re-upload or
    # per-insert recompile would crater this number)
    mutate_qps = None
    if "--mutate" in sys.argv:
        import threading
        extra = mk_queries(4096)
        stop = threading.Event()
        inserted = []

        def writer():
            i = 0
            while not stop.is_set() and i < len(extra):
                slot = idx.insert(extra[i])
                inserted.append(slot)
                if i % 3 == 2:
                    idx.remove(inserted[-2])
                i += 1

        t = threading.Thread(target=writer)
        t.start()
        qps_rounds = []
        for r in range(7):
            t0 = time.perf_counter()
            for i in range(depth):
                idx.search(q_batches[i], k)
            dt = time.perf_counter() - t0
            if r >= 2:
                qps_rounds.append(depth * batch / dt)
        stop.set()
        t.join()
        mutate_qps = float(np.median(qps_rounds))
        log(f"interleaved mutate/search: {mutate_qps:.0f} QPS "
            f"({len(inserted)} inserts during measurement) vs "
            f"{best_qps:.0f} read-only")

    baseline_qps = 1.0 / 0.87e-3  # reference 0.87 ms/query
    print(json.dumps({
        "metric": "HNSW bf16 QPS/chip at recall@10 "
                  f"(1M x {d}d clustered, ef=128, batch=512)",
        "value": round(best_qps, 1),
        "unit": "qps",
        "vs_baseline": round(best_qps / baseline_qps, 2),
        "recall_at_10": round(float(recall), 4),
        "p50_batch_latency_ms": round(p50_batch_ms, 3),
        "build_seconds": round(build_s, 1),
        "build_rows_per_s": round(n / build_s, 1),
        "builder": builder,
        "mutate_search_qps": (round(mutate_qps, 1)
                              if mutate_qps is not None else None),
        "dim": d,
        "ef_sweep": ef_sweep,
        "devices": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
