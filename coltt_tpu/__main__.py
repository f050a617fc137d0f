"""Process entry: ``python -m coltt_tpu -mode edge``.

Reference parity: ``cmd/root/main.go:38-90`` — parse ``-mode``, create the
data directory, start the profiling endpoint and the service layer, then
block until SIGINT/SIGTERM and gracefully stop with a 10 s timeout (flush +
snapshot every loaded collection on the way down).
"""

from __future__ import annotations

import argparse
import http.server
import os
import signal
import threading

from coltt_tpu.utils.config import load_config
from coltt_tpu.utils.logging import get_logger

log = get_logger("main")


def _start_prof_server(addr: str) -> None:
    """pprof-equivalent: a tiny HTTP endpoint exposing thread stacks and
    process stats (net/http/pprof parity, cmd/root/main.go:61-75). JAX device
    profiling is exposed via jax.profiler on demand."""
    host, _, port = addr.rpartition(":")

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            import sys
            import traceback

            frames = sys._current_frames()
            body = "".join(
                f"--- thread {tid} ---\n" + "".join(traceback.format_stack(frame))
                for tid, frame in frames.items()
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    try:
        server = http.server.ThreadingHTTPServer((host or "0.0.0.0", int(port)), Handler)
    except OSError as e:
        log.warning(f"prof server unavailable: {e}")
        return
    threading.Thread(target=server.serve_forever, daemon=True).start()
    log.info("prof server listening", extra={"kv": {"addr": addr}})


def main() -> None:
    parser = argparse.ArgumentParser("coltt-tpu")
    parser.add_argument(
        "-mode", "--mode", default=None,
        help="root (HNSW core) | edge (quantized FLAT) | experimental (CFLAT)",
    )
    parser.add_argument("--config", default="coltt.toml")
    parser.add_argument("--bind", default=None, help="override bind address")
    args = parser.parse_args()

    cfg = load_config(args.config)
    if args.mode:
        cfg.mode = args.mode
    if args.bind:
        cfg.root_layer.bind_address = args.bind

    os.makedirs(cfg.storage.data_dir, exist_ok=True)
    _start_prof_server(cfg.root_layer.prof_address)

    # Warm up the accelerator before accepting traffic: first-touch device
    # init and compiles take seconds; paying them at boot keeps RPC
    # latencies honest. The persistent compilation cache (one fixed
    # directory, utils/compile_cache.py) makes later restarts fast, and
    # its hit/miss counts tell a cold boot from a cache that never hits.
    import jax
    import jax.numpy as jnp

    from coltt_tpu.utils.compile_cache import CacheCounter, configure_compile_cache

    cache_dir = configure_compile_cache()
    cache_stats = CacheCounter()
    log.info("warming up device", extra={"kv": {"devices": str(jax.devices())}})
    jnp.zeros((8, 128)).sum().block_until_ready()
    log.info(
        "device ready",
        extra={"kv": {"compile_cache": cache_dir, **cache_stats.snapshot()}},
    )

    from coltt_tpu.api.server import build_servicer, create_server

    servicer = build_servicer(cfg.mode, cfg)
    server = create_server(servicer, cfg)
    # freeze the boot-time object graph out of the cyclic GC: gen-2
    # collections over a loaded engine (100k+ index entries) measured
    # 100-175 ms pauses that land on request latencies; frozen objects
    # are never scanned again (refcounting still reclaims request-scoped
    # garbage immediately). Freeze BEFORE start(): once the listener is
    # up, in-flight request objects could be swept into the frozen set,
    # where cyclic request garbage would become permanently unreclaimable.
    import gc
    gc.collect()
    gc.freeze()
    server.start()
    log.info(
        "server started",
        extra={"kv": {"mode": cfg.mode, "addr": cfg.root_layer.bind_address}},
    )

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()

    log.info("shutting down (grace 10s)")
    server.stop(grace=10).wait(timeout=10)
    engine = servicer.engine
    if hasattr(engine, "close"):
        engine.close()  # flush / snapshot loaded collections
    log.info("bye")


if __name__ == "__main__":
    main()
