"""gRPC search benchmark against a running edge-mode server.

Reference parity: ``benchmark/coltt_edge.go`` / ``compared_edge.go`` —
client-measured search latency distribution over the full RPC path
(marshal -> server -> device scan -> marshal), the number a user actually
sees. The reference's best published figure is 0.02-0.03 s/query on
1M x 128d with highCpu=true (UPDATE-LOG.md:107).

Manual-run integration harness (needs a live server; see README):

    python -m coltt_tpu --config coltt.toml &        # mode = "edge"
    python benchmark/grpc_edge_search.py --n 100000 --queries 500

The client never touches a JAX device (it only imports the package for
the proto stubs), so the server stays the one process on the card.
"""

import argparse
import json
import time

import grpc
import numpy as np

from coltt_tpu.api.client import EdgeClient
from coltt_tpu.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu.ops.quant import Quantization


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", default="127.0.0.1:50051")
    ap.add_argument("--collection", default="bench_search")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--limit", type=int, default=10)
    ap.add_argument("--quantization", default="I8")
    ap.add_argument("--high-resource", action="store_true",
                    help="the reference's highCpu toggle: fused/approx scan")
    ap.add_argument("--concurrency", type=int, default=1,
                    help=">1 adds a concurrent-clients phase (ScanBatcher)")
    ap.add_argument("--one-by-one", action="store_true",
                    help="ingest via single Index RPCs (reference shape)")
    ap.add_argument("--coldcheck", action="store_true",
                    help="release+load, then time the FIRST RPCs cold "
                         "(LoadCollection precompile / latency mode)")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    client = EdgeClient(grpc.insecure_channel(args.addr))
    try:
        client.delete_collection(args.collection)
    except Exception:
        pass
    schema = CollectionSchema(
        name=args.collection, dim=args.dim,
        quantization=Quantization.parse(args.quantization),
        fields=(FieldSchema(name="pk", type=FieldType.STRING, primary_key=True),
                FieldSchema(name="bucket", type=FieldType.INTEGER)),
    )
    client.create_collection(schema)

    t0 = time.perf_counter()
    batch = 4096
    for base in range(0, args.n, batch):
        m = min(batch, args.n - base)
        vecs = rng.standard_normal((m, args.dim)).astype(np.float32)
        if args.one_by_one:
            # the reference's only ingest shape (one IndexChange per RPC)
            for i in range(m):
                client.index(args.collection, f"p{base + i}", vector=vecs[i],
                             metadata={"pk": f"p{base+i}",
                                       "bucket": (base + i) % 16})
        else:
            client.bulk_index(
                args.collection,
                [f"p{base + i}" for i in range(m)],
                vecs,
                [{"bucket": (base + i) % 16} for i in range(m)],
            )
    ingest_s = time.perf_counter() - t0
    print(f"ingest {args.n} rows: {ingest_s:.1f}s "
          f"({args.n/ingest_s:.0f} rows/s; reference one-by-one ~1.7k/s)",
          flush=True)

    qs = rng.standard_normal((args.queries, args.dim)).astype(np.float32)

    # latency mode check (VERDICT r4 #6): release + load the collection —
    # LoadCollection precompiles the small-batch serving shapes — then time
    # the very FIRST single-query RPCs with no warmup. Done-bar: cold
    # first-RPC p50 within 2x of warm p50.
    cold_ms = None
    if args.coldcheck:
        client.flush(args.collection)
        client.release_collection(args.collection)
        t0 = time.perf_counter()
        client.load_collection(args.collection)
        load_s = time.perf_counter() - t0
        cold = []
        for i in range(5):
            t1 = time.perf_counter()
            client.search(args.collection, qs[i], limit=args.limit,
                          high_resource=args.high_resource)
            cold.append(time.perf_counter() - t1)
        cold_ms = [round(x * 1e3, 2) for x in cold]
        print(f"load (incl. precompile): {load_s:.1f}s; "
              f"first-5 cold RPCs: {cold_ms} ms", flush=True)

    client.search(args.collection, qs[0], limit=args.limit,
                  high_resource=args.high_resource)  # warmup/compile
    lats = []
    t0 = time.perf_counter()
    for i in range(args.queries):
        t1 = time.perf_counter()
        client.search(args.collection, qs[i], limit=args.limit,
                      high_resource=args.high_resource)
        lats.append(time.perf_counter() - t1)
    total = time.perf_counter() - t0
    lats_ms = np.asarray(lats) * 1e3
    out = {
        "metric": "edge search latency over gRPC (single-query RPCs)",
        "n": args.n, "dim": args.dim,
        "quantization": args.quantization,
        "high_resource": args.high_resource,
        "p50_ms": round(float(np.percentile(lats_ms, 50)), 3),
        "p95_ms": round(float(np.percentile(lats_ms, 95)), 3),
        "p99_ms": round(float(np.percentile(lats_ms, 99)), 3),
        "qps_sequential": round(args.queries / total, 1),
        "reference_p50_ms": "20-30 (1M x 128d, highCpu=true)",
    }
    if cold_ms is not None:
        out["cold_first_rpcs_ms"] = cold_ms
        out["cold_first_p50_ms"] = round(float(np.median(cold_ms)), 2)
        out["cold_within_2x_warm"] = bool(
            np.median(cold_ms) <= 2.0 * out["p50_ms"]
        )

    if args.concurrency > 1:
        # concurrent clients: the server's ScanBatcher coalesces in-flight
        # searches into one device scan (engine/batcher.py) — the serving
        # throughput story, measured through the full RPC path
        from concurrent.futures import ThreadPoolExecutor

        total_q = args.queries * args.concurrency
        cqs = rng.standard_normal((total_q, args.dim)).astype(np.float32)
        pool = ThreadPoolExecutor(args.concurrency)

        def one(i):
            t1 = time.perf_counter()
            client.search(args.collection, cqs[i], limit=args.limit,
                          high_resource=args.high_resource)
            return time.perf_counter() - t1

        t0 = time.perf_counter()
        clats = list(pool.map(one, range(total_q)))
        cdt = time.perf_counter() - t0
        cl = np.asarray(clats) * 1e3
        out["concurrency"] = args.concurrency
        out["qps_concurrent"] = round(total_q / cdt, 1)
        out["concurrent_p50_ms"] = round(float(np.percentile(cl, 50)), 3)
        out["concurrent_p99_ms"] = round(float(np.percentile(cl, 99)), 3)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
