"""CFLAT batch serving benchmark: VectorSearchBatch QPS through real gRPC.

The reference-parity VectorSearch RPC carries ONE multi-vector query per
call, capping served multi-vector traffic at single-RPC rates.
VectorSearchBatch (beyond the reference
surface, mirroring edge/core SearchBatch) carries a [count, dim_f] raw-f32
block per included field and returns columnar hits.

Manual-run integration harness (needs a live experimental server):

    python -m coltt_tpu --config coltt.toml &    # mode = "experimental"
    python benchmark/grpc_cflat_batch.py --n 1000000 --batch 1024 \
        --concurrency 4 --rounds 8

The client never touches a JAX device (it only imports the package for
the proto stubs), so the server stays the one process on the card.
"""

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import grpc
import numpy as np

from coltt_tpu.api.client import ExperimentalClient
from coltt_tpu.index.schema import CollectionSchema, FieldSchema, FieldType


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", default="127.0.0.1:50051")
    ap.add_argument("--collection", default="bench_cflat")
    ap.add_argument("--dims", default="768,768",
                    help="comma-separated per-field dims (the engine's "
                         "schema gives every vector field the collection "
                         "dim — reference parity — so these must be equal; "
                         "768+768 is a conservative superset of the "
                         "in-process bench's 768+256 FLOPs)")
    ap.add_argument("--ratios", default="70,30")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=1024,
                    help="queries per VectorSearchBatch RPC")
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--ingest-chunk", type=int, default=65_536)
    ap.add_argument("--skip-ingest", action="store_true")
    args = ap.parse_args()

    dims = [int(x) for x in args.dims.split(",")]
    ratios = [int(x) for x in args.ratios.split(",")]
    fields = [f"f{i}" for i in range(len(dims))]
    rng = np.random.default_rng(0)
    channel = grpc.insecure_channel(
        args.addr,
        options=[("grpc.max_send_message_length", 512 << 20),
                 ("grpc.max_receive_message_length", 512 << 20)],
    )
    client = ExperimentalClient(channel)

    if len(set(dims)) != 1:
        ap.error("all field dims must be equal (schema gives every vector "
                 "field the collection dim)")
    if not args.skip_ingest:
        schema = CollectionSchema(
            name=args.collection, dim=dims[0],
            fields=[FieldSchema(f, FieldType.VECTOR) for f in fields],
        )
        client.create_collection(schema)
        t0 = time.perf_counter()
        done = 0
        while done < args.n:
            c = min(args.ingest_chunk, args.n - done)
            client.bulk_index(
                args.collection,
                [f"r{done + i}" for i in range(c)],
                {f: rng.standard_normal((c, d), dtype=np.float32)
                 for f, d in zip(fields, dims)},
            )
            done += c
            print(f"ingested {done}/{args.n} "
                  f"({done / (time.perf_counter() - t0):.0f} rows/s)")
        print(f"ingest {args.n} rows: {time.perf_counter() - t0:.1f}s")

    def one_rpc(qblocks):
        return client.vector_search_batch(
            args.collection,
            [(f, qb, True, r) for f, qb, r in
             zip(fields, qblocks, ratios)],
            top_k=args.topk,
        )

    qsets = [
        [rng.standard_normal((args.batch, d), dtype=np.float32) for d in dims]
        for _ in range(args.concurrency)
    ]
    t0 = time.perf_counter()
    one_rpc(qsets[0])  # warmup / compile
    print(f"warmup RPC: {time.perf_counter() - t0:.1f}s")

    pool = ThreadPoolExecutor(args.concurrency)

    def worker(i):
        lat = []
        for _ in range(args.rounds):
            t = time.perf_counter()
            counts, _, _, _ = one_rpc(qsets[i])
            lat.append(time.perf_counter() - t)
            assert len(counts) == args.batch
        return lat

    t0 = time.perf_counter()
    lats = [x for f in [pool.submit(worker, i)
                        for i in range(args.concurrency)]
            for x in f.result()]
    wall = time.perf_counter() - t0
    total_q = args.concurrency * args.rounds * args.batch
    print(json.dumps({
        "metric": "CFLAT VectorSearchBatch QPS through gRPC "
                  f"({args.n} recs x {args.dims}d, batch={args.batch}, "
                  f"conc={args.concurrency})",
        "value": round(total_q / wall, 1),
        "unit": "qps",
        "p50_rpc_ms": round(float(np.median(lats)) * 1e3, 2),
        "p95_rpc_ms": round(float(np.quantile(lats, 0.95)) * 1e3, 2),
    }))


if __name__ == "__main__":
    main()
