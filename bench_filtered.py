"""Filtered-search selectivity sweep (VERDICT r3 item 5).

Reference anchor: filtered scan is a core feature of the reference's edge
mode (``edge/f16_vectorstore.go:188-263`` — the scan loop takes the
inverted-index candidate set). Here FlatStore.search(candidates=...) has
two regimes: a gather kernel (pack the candidate rows, scan only them)
below ``capacity // _GATHER_FRACTION`` candidates, and a masked full scan
above. This bench measures QPS + recall@10 per selectivity on 1M x 768d
i8 and, around the crossover, BOTH regimes — the data behind the
``_GATHER_FRACTION = 8`` constant (which r03 shipped unmeasured).

Prints ONE JSON line. Run: timeout 3600 python -u bench_filtered.py
"""

import json
import os
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

    import coltt_tpu.store.flat as flat_mod
    from coltt_tpu.ops.distance import Metric
    from coltt_tpu.ops.quant import Quantization
    from coltt_tpu.ops.topk import compute_recall
    from coltt_tpu.store.flat import FlatStore

    n = int(os.environ.get("BENCH_N", 1_000_000))  # small for CPU smoke
    d, k = 768, 10
    batch = 512
    rounds = 7  # median of 5 after 2 warm
    n_recall = 512

    log(f"devices: {jax.devices()}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    log(f"data gen (host): {time.perf_counter()-t0:.1f}s")

    store = FlatStore(d, metric=Metric.COSINE, quantization=Quantization.I8)
    gt = FlatStore(d, metric=Metric.COSINE, quantization=Quantization.NONE)
    pks = [str(i) for i in range(n)]
    t0 = time.perf_counter()
    store.bulk_build(pks, vecs)
    gt.bulk_build(pks, vecs)
    log(f"bulk_build i8 + f32 GT: {time.perf_counter()-t0:.1f}s")

    queries = rng.standard_normal((batch, d)).astype(np.float32)
    rq = queries[:n_recall]

    results = {}
    # selectivities spanning both regimes; capacity = 2^20 -> crossover at
    # capacity // 8 = 131072 candidates (12.5%)
    for frac in (0.0001, 0.001, 0.01, 0.05, 0.125, 0.25, 0.5):
        m = max(k, int(n * frac))
        cand = rng.choice(n, size=m, replace=False).astype(np.int32)
        regimes = ["auto"]
        if 0.04 <= frac <= 0.26:
            regimes = ["gather", "masked"]  # measure both near the crossover
        for regime in regimes:
            old = flat_mod._GATHER_FRACTION
            if regime == "gather":
                flat_mod._GATHER_FRACTION = 1          # everything gathers
            elif regime == "masked":
                flat_mod._GATHER_FRACTION = 1 << 30    # nothing gathers
            try:
                store.search(queries, k, candidates=cand)  # warm/compile
                qps_rounds = []
                for r in range(rounds):
                    t0 = time.perf_counter()
                    store.search(queries, k, candidates=cand)
                    dt = time.perf_counter() - t0
                    if r >= 2:
                        qps_rounds.append(batch / dt)
                qps = float(np.median(qps_rounds))
                _, got = store.search(rq, k, candidates=cand)
                _, truth = gt.search(rq, k, candidates=cand)
                rec = float(compute_recall(got, truth))
            finally:
                flat_mod._GATHER_FRACTION = old
            key = f"{frac:g}" + ("" if regime == "auto" else f"/{regime}")
            results[key] = {
                "candidates": int(m),
                "qps_median5": round(qps, 1),
                "recall_at_10": round(rec, 4),
            }
            log(f"sel {key}: {m} cands, {qps:.0f} QPS, recall {rec:.4f}")

    print(json.dumps({
        "metric": "filtered FLAT i8 QPS at recall@10 by selectivity "
                  "(1M x 768d, batch=512)",
        "value": results["0.01"]["qps_median5"],
        "unit": "qps",
        "vs_baseline": None,
        "selectivities": results,
        "devices": len(jax.devices()),
    }))
    with open("BENCH_filtered.json", "w") as fh:
        json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
