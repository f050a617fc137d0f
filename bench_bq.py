"""BQ (binary quantization) bench: recall/QPS at 1M and 10M x 768d.

Round-1 item 9's done-bar: BQ benched at both scales — 10M x 768d is where
the 32x memory win becomes decisive (packed corpus 960 MB vs 30 GB f32; an
f32 corpus at 10M x 768d is 30 GB). The serving path is
``DistributedFlatIndex(quantization=BQ)``: packed XOR+popcount Hamming
shortlist (k*oversample) + bf16 rerank of the gathered shortlist +
collective merge — the same path a BQ collection created through the gRPC
surface runs (tests/test_api.py::test_core_bq_collection_via_rpc).

At 10M a bf16 rerank copy (15 GB) would crowd a 16 GB device, so 10M runs rerank-free
(ranking = the random-hyperplane angle estimate alone — the honest
memory-minimal configuration) AND with an f8 (e4m3) rerank copy (7.5 GB —
fits beside the 960 MB codes); 1M runs with bf16 rerank and rerank-free.
Methodology: recall on 512 queries, QPS median-of-5 after 2 warm
rounds.
Corpus: the same embedding-like cluster mixture the PQ/HNSW benches use
(16k centers x sigma 0.35) — on i.i.d. gaussians the top-of-corpus cosine
spread (~0.05) sits BELOW the 768-bit Hamming angle resolution (~0.06
rad), so BQ ranking is noise for ANY implementation (recall@10
0.03-0.17); sign sketches need data whose neighbors are actually close in
angle, which real embeddings are. Corpus slabs are generated on device,
BQ-encoded, and freed — the f32 form never accumulates. Prints ONE JSON
line (headline = the 10M row).

Run on the GPU:  timeout 5400 python -u bench_bq.py
"""

import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


SLAB = 1_000_000


def main():
    import os

    import jax

    from coltt_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    import coltt_tpu.ops.bq as bq_mod
    from coltt_tpu.ops.bq import bq_encode
    from coltt_tpu.ops.distance import Metric
    from coltt_tpu.ops.quant import Quantization
    from coltt_tpu.parallel.dist_search import DistributedFlatIndex
    from coltt_tpu.parallel.mesh import BATCH_AXIS, make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    d, k, depth = 768, 10, 4
    log(f"devices: {jax.devices()}")
    mesh = make_mesh(num_shards=len(jax.devices()), batch=1)
    qspec = NamedSharding(mesh, P(BATCH_AXIS))
    results = {}

    n_centers, sigma = 16384, 0.35
    centers = jax.random.normal(
        jax.random.PRNGKey(42), (n_centers, d), jnp.float32
    )

    def slab_key(i):
        return jax.random.fold_in(jax.random.PRNGKey(7), i)

    from functools import partial

    @partial(jax.jit, static_argnums=(1,))
    def _mk(k1, asg_rows):
        ka, kb = jax.random.split(k1)
        asg = jax.random.randint(ka, (asg_rows,), 0, n_centers)
        noise = jax.random.normal(kb, (asg_rows, d), jnp.float32)
        return jnp.take(centers, asg, axis=0) + sigma * noise

    def gen_slab(i, rows):
        return _mk(slab_key(i), rows)

    legs = ((1_000_000, "bf16"), (1_000_000, None),
            (10_000_000, "f8"), (10_000_000, None))
    if "--only10m" in sys.argv:
        legs = ((10_000_000, "f8"), (10_000_000, None))
    for n, rr_mode in legs:
        tag = f"{n//1_000_000}M" + (f"+rr_{rr_mode}" if rr_mode else "")
        # 10M + the 7.9 GB f8 rerank copy leaves ~6 GB headroom, and the
        # 690 s slab ingest fragments the heap: batch 2048 AND 1024 both
        # OOM'd in the QPS loop. Shrink the query batch and the blocked
        # Hamming scan's transient budget for this leg.
        batch = 512 if (n > 1_000_000 and rr_mode) else 2048
        bq_mod._BQ_TRANSIENT_BYTES = (
            256 << 20 if (n > 1_000_000 and rr_mode) else 1 << 30
        )
        nslabs = -(-n // SLAB)
        t0 = time.perf_counter()
        if rr_mode == "bf16" and n <= SLAB:
            vecs = gen_slab(0, n)  # 1M only: fits comfortably
            idx = DistributedFlatIndex(
                mesh, vecs, metric=Metric.COSINE,
                quantization=Quantization.BQ, rerank_dtype=jnp.bfloat16,
            )
            del vecs
        else:
            parts, rr_parts = [], []
            for i in range(nslabs):
                rows = min(SLAB, n - i * SLAB)
                s = gen_slab(i, rows)
                parts.append(np.asarray(bq_encode(s)))
                if rr_mode == "f8":
                    # f8 (e4m3) rerank copy: 1 byte/dim — the 10M-scale
                    # configuration where a bf16 copy (15 GB) can't fit
                    rr_parts.append(
                        np.asarray(s.astype(jnp.float8_e4m3fn))
                    )
                del s
            idx = DistributedFlatIndex.from_bq_codes(
                mesh, np.concatenate(parts), dim=d,
                rr_codes=(np.concatenate(rr_parts) if rr_parts else None),
                rerank_dtype=jnp.float8_e4m3fn,
            )
            del parts, rr_parts
        jax.block_until_ready(idx.codes)
        log(f"[{tag}] ingest+pack: {time.perf_counter()-t0:.1f}s "
            f"(packed {idx.codes.nbytes/2**20:.0f} MiB)")

        kq = jax.random.PRNGKey(1)
        qkeys = jax.random.split(kq, depth + 1)
        q_batches = [
            np.asarray(jax.device_get(_mk(qk, batch))) for qk in qkeys
        ]

        # at 10M the 768-bit Hamming ranking needs a deeper shortlist:
        # sweep oversample on the same index (os=16 measured .569 with the
        # f8 rerank at 10M; the FlatStore default for BQ is 64). The r5
        # capped per-block keep (ops/bq.py) makes deep oversample
        # affordable — os=128 probes the recall ceiling beyond .895.
        os_list = (16, 64, 128) if n > 1_000_000 else (16,)
        per_os = {}
        for os_ in os_list:
            t0 = time.perf_counter()
            idx.search(q_batches[0], k, oversample=os_)
            log(f"[{tag}] os={os_} warmup: {time.perf_counter()-t0:.1f}s")
            qps_rounds = []
            for r in range(7):
                t0 = time.perf_counter()
                for i in range(depth):
                    idx.search(q_batches[i], k, oversample=os_)
                dt = time.perf_counter() - t0
                if r >= 2:
                    qps_rounds.append(depth * batch / dt)
            per_os[os_] = float(np.median(qps_rounds))
        best_qps = per_os[os_list[0]]

        # recall vs exact fp32 cosine over the same data, slab-streamed
        gq = q_batches[depth][:512]
        jq = jnp.asarray(gq)
        qn = jnp.linalg.norm(jq, axis=1, keepdims=True)
        best_d = jnp.full((len(gq), k), -jnp.inf)
        best_i = jnp.full((len(gq), k), -1, jnp.int32)
        qc = 128  # query chunk: the [qc, SLAB] f32 cos transient is 0.5 GB
        # (the unchunked [512, 1M] matrix was 2 GB — it OOM'd next to the
        # 10M index + one 3 GB f32 slab)
        for i in range(nslabs):
            rows = min(SLAB, n - i * SLAB)
            s = gen_slab(i, rows)
            sn = jnp.maximum(jnp.linalg.norm(s, axis=1), 1e-30)
            for q0 in range(0, len(gq), qc):
                cos = (jq[q0:q0 + qc] @ s.T) / (qn[q0:q0 + qc] * sn[None, :])
                dd, ii = jax.lax.top_k(cos, k)
                del cos
                cand_d = jnp.concatenate([best_d[q0:q0 + qc], dd], axis=1)
                cand_i = jnp.concatenate(
                    [best_i[q0:q0 + qc], ii.astype(jnp.int32) + i * SLAB],
                    axis=1,
                )
                bd, sel = jax.lax.top_k(cand_d, k)
                bi = jnp.take_along_axis(cand_i, sel, axis=1)
                best_d = best_d.at[q0:q0 + qc].set(bd)
                best_i = best_i.at[q0:q0 + qc].set(bi)
            del s
        gt = np.asarray(best_i)
        row = {"batch": batch}
        for os_ in os_list:
            _, got = idx.search(gq, k, oversample=os_)
            recall = float(np.mean([
                len(set(gt[i]) & set(got[i])) / k for i in range(len(gq))
            ]))
            log(f"[{tag}] os={os_}: QPS {per_os[os_]:.0f}; "
                f"recall@10 {recall:.3f}")
            row[f"os{os_}"] = {"qps": round(per_os[os_], 1),
                               "recall_at_10": round(recall, 4)}
        # headline fields keep the old shape (first os)
        first = row[f"os{os_list[0]}"]
        row["qps"] = first["qps"]
        row["recall_at_10"] = first["recall_at_10"]
        results[tag] = row
        del idx
        # merge with any earlier partial run's rows
        try:
            with open("BENCH_bq.json") as fh:
                prev = json.load(fh)
        except (OSError, ValueError):
            prev = {}
        prev.update(results)
        results = prev
        with open("BENCH_bq.json", "w") as fh:
            json.dump(results, fh, indent=1)

    with open("BENCH_bq.json", "w") as fh:
        json.dump(results, fh, indent=1)
    baseline_qps = 40.0  # reference highCpu FLAT 1M x 128d (BASELINE.md)
    head = results["10M+rr_f8"]
    print(json.dumps({
        "metric": "BQ packed-Hamming + f8 rerank QPS/chip at recall@10 "
                  "(10M x 768d, oversample=16, batch=2048)",
        "value": head["qps"],
        "unit": "qps",
        "vs_baseline": round(head["qps"] / baseline_qps, 2),
        "recall_at_10": head["recall_at_10"],
        "all": results,
        "devices": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
