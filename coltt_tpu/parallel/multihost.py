"""Multi-host serving: distributed runtime init, host-major meshes, and
host-local ingest assembly.

This is the real version of the cluster layer the reference describes but
never shipped (README "ARCHITECTURE" replica/shard LB + NATS JetStream;
the actual ``loadbalancer/`` package is two empty files and
``config.JetStream`` is never read — SURVEY.md §1 note, §2.7 item 5).
Instead of application-level replication we scale the corpus axis across
hosts with JAX's multi-controller runtime:

- every host runs the same process and calls :func:`init_distributed`;
- :func:`make_multihost_mesh` lays the corpus ("shard") axis out so that
  consecutive shards live on one host's devices (within-host links)
  before crossing hosts (the network) — the per-shard scan never
  communicates, and the only cross-host traffic is the [Q, k] partial
  merge (bytes, not the corpus), which the network handles easily;
- :func:`assemble_global_rows` builds the globally-sharded [N, D] array
  from each host's local rows without ever materializing the corpus on
  one host (each host feeds only its shard — the multi-host version of
  the reference's per-shard map ingest).

Single-process (tests, one device) all of this degrades gracefully:
init is a no-op, the mesh is the local mesh, and assembly is a device_put.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from coltt_tpu.parallel.mesh import BATCH_AXIS, SHARD_AXIS
from coltt_tpu.utils.logging import get_logger, kv

log = get_logger("parallel.multihost")


def init_distributed(
    coordinator_address: Optional[str] = None,
    *,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize the JAX multi-controller runtime; returns process count.

    With no arguments, JAX's environment auto-detection is used (cluster
    schedulers it knows set the topology env vars); on a single host this
    is a no-op. Call before any other JAX API, once per process.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)
    nproc = jax.process_count()
    log.info(
        "distributed runtime ready",
        extra=kv(
            processes=nproc,
            process_id=jax.process_index(),
            local_devices=len(jax.local_devices()),
            global_devices=len(jax.devices()),
        ),
    )
    return nproc


def make_multihost_mesh(*, batch: int = 1) -> Mesh:
    """(shard, batch) mesh over all hosts' devices, host-major.

    The shard axis is ordered host-by-host: shard s lives on host
    s * hosts // shards. The all-gather in the top-k merge then
    decomposes into a within-host phase and an across-host phase, both
    on [Q, k]-sized tensors.

    ``batch`` > 1 carves a query-data-parallel axis out of each host's
    devices (it must divide the per-host device count so a query batch
    never straddles hosts).
    """
    devices = jax.devices()
    n = len(devices)
    if batch < 1 or n % batch:
        raise ValueError(f"batch={batch} must divide device count {n}")
    per_host = len(jax.local_devices())
    if batch > 1 and per_host % batch:
        raise ValueError(
            f"batch={batch} must divide per-host device count {per_host} "
            "so query batches stay within a host"
        )
    # jax.devices() is already process-major (host-major); keep that order
    grid = np.array(devices).reshape(n // batch, batch)
    return Mesh(grid, (SHARD_AXIS, BATCH_AXIS))


def host_row_range(n: int, mesh: Mesh) -> tuple[int, int]:
    """[start, end) of the global [N] row axis this host's shards own.

    Rows are block-partitioned over the shard axis; a host owns the
    union of its devices' blocks (contiguous, because the mesh is
    host-major). Use to decide which rows to load/ingest locally.
    """
    n_shards = mesh.shape[SHARD_AXIS]
    if n % n_shards:
        raise ValueError(f"n={n} must be divisible by shards={n_shards}")
    rows_per_shard = n // n_shards
    # which shard indices live on this process
    mine = [
        i for i in range(n_shards)
        if any(d.process_index == jax.process_index()
               for d in np.asarray(mesh.devices)[i])
    ]
    if not mine:
        return 0, 0
    assert mine == list(range(mine[0], mine[-1] + 1)), (
        "host's shards must be contiguous (host-major mesh)"
    )
    return mine[0] * rows_per_shard, (mine[-1] + 1) * rows_per_shard


def assemble_global_rows(mesh: Mesh, local_rows: np.ndarray, n: int
                         ) -> jax.Array:
    """Build the global [n, ...] shard-axis array from this host's rows.

    ``local_rows`` must be exactly the rows of :func:`host_row_range`.
    Single-process this is a sharded device_put; multi-process it uses
    ``jax.make_array_from_process_local_data`` so no host ever holds the
    full corpus.
    """
    spec = NamedSharding(mesh, P(SHARD_AXIS))
    shape = (n,) + tuple(local_rows.shape[1:])
    if jax.process_count() == 1:
        if local_rows.shape[0] != n:
            raise ValueError(
                f"single-process assembly needs all {n} rows, "
                f"got {local_rows.shape[0]}"
            )
        return jax.device_put(local_rows, spec)
    start, end = host_row_range(n, mesh)
    if local_rows.shape[0] != end - start:
        raise ValueError(
            f"host owns rows [{start}, {end}) = {end - start} rows, "
            f"got {local_rows.shape[0]}"
        )
    return jax.make_array_from_process_local_data(spec, local_rows, shape)
