"""Multi-chip / multi-host parallel layer.

Replaces the reference's parallelism inventory (SURVEY.md §2.7): the 16-way
goroutine shard scan becomes a corpus axis sharded over a
``jax.sharding.Mesh`` with per-device local top-k and an all-gather merge
over the device interconnect (and the network across hosts); the
vestigial ``loadbalancer/`` package
becomes real data-parallel query batching over a second mesh axis.
"""

from coltt_tpu.parallel.mesh import make_mesh, shard_spec, replicated_spec
from coltt_tpu.parallel.dist_search import sharded_scan_topk, DistributedFlatIndex
from coltt_tpu.parallel.multihost import (
    assemble_global_rows,
    host_row_range,
    init_distributed,
    make_multihost_mesh,
)

__all__ = [
    "make_mesh",
    "shard_spec",
    "replicated_spec",
    "sharded_scan_topk",
    "DistributedFlatIndex",
    "init_distributed",
    "make_multihost_mesh",
    "host_row_range",
    "assemble_global_rows",
]
