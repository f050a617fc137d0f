"""gRPC insert benchmark against a running root-mode server.

Reference parity: ``benchmark/coltt_core.go:33-89`` + ``bench_insert.py``
— the reference inserts 1M x 128d one-by-one over gRPC in ~584-704 s
(BASELINE.md) with staged timings at 1k/5k/10k/50k/100k/500k/1M. This
harness measures both that one-by-one path and the BulkInsert RPC this
build adds (the reference has no bulk path; Milvus was ~10x faster at
ingest, examples/release/2024_11_20_release.md:29-31).

Manual-run integration harness (needs a live server; see README):

    python -m coltt_tpu --config coltt.toml &        # mode = "root"
    python benchmark/grpc_core_insert.py --n 100000 --one-by-one-n 5000

The client never touches a JAX device (it only imports the package for
the proto stubs), so the server stays the one process on the card.
"""

import argparse
import json
import time

import grpc
import numpy as np

from coltt_tpu.api.client import CoreClient

STAGES = (1_000, 5_000, 10_000, 50_000, 100_000, 500_000, 1_000_000)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", default="127.0.0.1:50051")
    ap.add_argument("--collection", default="bench_insert")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--one-by-one-n", type=int, default=10_000,
                    help="rows to insert via single-row RPCs before "
                         "switching to BulkInsert (0 = bulk only)")
    ap.add_argument("--bulk-batch", type=int, default=65_536)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    client = CoreClient(grpc.insecure_channel(args.addr))
    try:
        client.drop_collection(args.collection)
    except Exception:
        pass
    client.create_collection(args.collection, args.dim)
    client.load_collection(args.collection)

    report = {"metric": "core insert wall-time over gRPC",
              "dim": args.dim, "stages": {}}

    t_start = time.perf_counter()
    done = 0
    one_by_one = min(args.one_by_one_n, args.n)
    while done < one_by_one:
        vec = rng.standard_normal(args.dim).astype(np.float32)
        client.insert(args.collection, vec, {"seq": done})
        done += 1
        if done in STAGES:
            report["stages"][str(done)] = round(time.perf_counter() - t_start, 2)
    t_obo = time.perf_counter() - t_start
    if one_by_one:
        print(f"one-by-one: {one_by_one} rows in {t_obo:.1f}s "
              f"({one_by_one/t_obo:.0f} rows/s; reference ~1.7k rows/s)",
              flush=True)
        report["one_by_one"] = {"rows": one_by_one, "seconds": round(t_obo, 2)}

    while done < args.n:
        m = min(args.bulk_batch, args.n - done)
        vecs = rng.standard_normal((m, args.dim)).astype(np.float32)
        client.bulk_insert(args.collection, vecs,
                           [{"seq": done + i} for i in range(m)])
        done += m
        if any(done >= s > done - m for s in STAGES):
            report["stages"][str(done)] = round(time.perf_counter() - t_start, 2)
    total = time.perf_counter() - t_start
    report["total_rows"] = args.n
    report["total_seconds"] = round(total, 2)
    report["rows_per_second"] = round(args.n / total, 1)
    # BASELINE.md: reference 1M x 128d one-by-one = 583.8 s (cache mode)
    report["vs_reference_1m_seconds"] = 583.83
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
