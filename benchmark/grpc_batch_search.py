"""Batch-native serving benchmark: SearchBatch QPS through the full gRPC path.

The reference-parity Search RPC carries ONE vector per call
(idl/proto/v4/edge.proto:28 in the reference), so client traffic could
never form the 2048-query batches the fused kernel wants. SearchBatch
(beyond the reference surface) carries a [count, dim] block per RPC with
raw-f32 payloads and a columnar response, so the serving layer can
actually drive the kernel.

Manual-run integration harness (needs a live edge server; see README):

    python -m coltt_tpu --config coltt.toml &        # mode = "edge"
    python benchmark/grpc_batch_search.py --n 1000000 --dim 768 \
        --batch 2048 --concurrency 4 --rounds 16 --high-resource

The client never touches a JAX device (it only imports the package for
the proto stubs), so the server stays the one process on the card.
"""

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import grpc
import numpy as np

from coltt_tpu.api.client import EdgeClient
from coltt_tpu.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu.ops.quant import Quantization


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", default="127.0.0.1:50051")
    ap.add_argument("--collection", default="bench_batch")
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=2048,
                    help="queries per SearchBatch RPC")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="client threads, each pipelining batches")
    ap.add_argument("--rounds", type=int, default=16,
                    help="RPCs per thread in the measured window")
    ap.add_argument("--limit", type=int, default=10)
    ap.add_argument("--quantization", default="I8")
    ap.add_argument("--high-resource", action="store_true",
                    help="fused Pallas kernel + ApproxTopK (serving mode)")
    ap.add_argument("--skip-ingest", action="store_true",
                    help="reuse an already-populated collection")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    channel = grpc.insecure_channel(
        args.addr,
        options=[("grpc.max_send_message_length", 64 << 20),
                 ("grpc.max_receive_message_length", 64 << 20)],
    )
    client = EdgeClient(channel)

    if not args.skip_ingest:
        try:
            client.delete_collection(args.collection)
        except Exception:
            pass
        schema = CollectionSchema(
            name=args.collection, dim=args.dim,
            quantization=Quantization.parse(args.quantization),
            fields=(
                FieldSchema(name="pk", type=FieldType.STRING, primary_key=True),
                FieldSchema(name="bucket", type=FieldType.INTEGER),
            ),
        )
        client.create_collection(schema)
        t0 = time.perf_counter()
        chunk = 2048  # 2048 x 768 f32 = 6.3 MB per RPC, under the msg cap
        for base in range(0, args.n, chunk):
            m = min(chunk, args.n - base)
            vecs = rng.standard_normal((m, args.dim)).astype(np.float32)
            client.bulk_index(
                args.collection,
                [f"p{base + i}" for i in range(m)],
                vecs,
                [{"bucket": (base + i) % 16} for i in range(m)],
            )
        ingest_s = time.perf_counter() - t0
        print(f"ingest {args.n} rows: {ingest_s:.1f}s "
              f"({args.n / ingest_s:.0f} rows/s via raw-f32 BulkIndex; "
              f"reference one-by-one ~1.7k/s)", flush=True)

    queries = rng.standard_normal(
        (args.concurrency, args.batch, args.dim)
    ).astype(np.float32)

    # warmup: compile the pow2 scan shapes (the server's persistent
    # compile cache makes reruns fast)
    t0 = time.perf_counter()
    client.search_batch(args.collection, queries[0], limit=args.limit,
                        high_resource=args.high_resource)
    print(f"warmup RPC: {time.perf_counter() - t0:.1f}s", flush=True)

    pool = ThreadPoolExecutor(args.concurrency)
    lats = []

    def run_thread(t):
        q = queries[t]
        times = []
        for _ in range(args.rounds):
            t1 = time.perf_counter()
            counts, scores, ids, _ = client.search_batch(
                args.collection, q, limit=args.limit,
                high_resource=args.high_resource,
            )
            times.append(time.perf_counter() - t1)
            assert len(counts) == args.batch
        return times

    t0 = time.perf_counter()
    for times in pool.map(run_thread, range(args.concurrency)):
        lats.extend(times)
    wall = time.perf_counter() - t0
    total_q = args.concurrency * args.rounds * args.batch
    lms = np.asarray(lats) * 1e3
    out = {
        "metric": "edge SearchBatch QPS through gRPC",
        "n": args.n, "dim": args.dim, "quantization": args.quantization,
        "batch": args.batch, "concurrency": args.concurrency,
        "high_resource": args.high_resource,
        "qps": round(total_q / wall, 1),
        "rpc_p50_ms": round(float(np.percentile(lms, 50)), 2),
        "rpc_p99_ms": round(float(np.percentile(lms, 99)), 2),
        "queries": total_q,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
