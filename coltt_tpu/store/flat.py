"""FLAT quantized vector store with slot-based mutation.

Reference parity: the four near-identical quantized vector spaces
``edge/{none,f16,f8,bf16}_vectorstore.go`` (16-way sharded
``map[uint64]ENode`` with upsert-resolves-primary-key, delete-via-filter,
full-scan VertexSearch with optional per-shard goroutines, and
FilterableVertexSearch over bitmap candidates) plus their binary
SaveVertex/LoadVertex snapshots (f16_vectorstore.go:317-460).

Design (SURVEY.md §7 phases 2-3): one store class parameterized
by quantization dtype instead of four copies. Vectors live in a dense
``[capacity, D]`` device array in storage dtype with a per-row fp32 scale,
precomputed squared norms, and a validity (tombstone) mask. Mutation is
slot-allocated + staged:

- upsert resolves the primary key to an existing slot (overwrite) or pops a
  free slot / appends; rows are staged host-side and applied to the device
  in one batched scatter (``.at[slots].set``) with buffer donation — the
  functional-update analogue of the reference's per-shard map writes.
- delete tombstones the slot (valid=False) and returns it to the free list;
  compaction is implicit (slots are reused) rather than stop-the-world.
- capacity grows by doubling in 8192-row quanta so the scan kernel always
  sees block-aligned shapes (no dynamic shapes under jit).

Search = the streaming scan in :mod:`coltt_tpu.ops.topk`. Filtered
search takes the candidate bitmap from the host index and picks between two
regimes (SURVEY.md §8 hard part (c)): a *gather* kernel when the candidate
set is small (rows gathered into a padded [C', D] tile) and a *masked full
scan* when it is large — the cost crossover is capacity/8.

PQ mode stores authoritative ``[cap, M] uint8`` codes (trained via
:mod:`coltt_tpu.ops.pq`) and, by default, decompresses them once per
mutation into an f8 *scan cache* so search runs at the same matmul /
bandwidth speed as F8 mode — decompress-at-search ADC is gather-bound,
far off the bandwidth bound at 10M rows (ROADMAP A6 re-measures this).
``pq_cache=False`` selects the low-memory blockwise-ADC scan instead
(codes only: D/8 bytes per row at the default subspace layout).
"""

from __future__ import annotations

import copy
import io
import threading
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from coltt_tpu.ops.bq import (
    bq_decode,
    bq_encode,
    bq_scan_neg_topk,
    bq_words,
    hamming_to_neg_cos_dist,
)
from coltt_tpu.ops.distance import Metric
from coltt_tpu.ops.pq import (
    PQCodebook,
    default_subspaces,
    pq_encode,
    pq_reconstruct,
    pq_scan_topk,
    pq_sqnorm,
    train_pq,
)
from coltt_tpu.ops.quant import Quantization, dequantize, quantize, storage_dtype
from coltt_tpu.ops.scan_pallas import fused_scan_topk
from coltt_tpu.ops.scan_pallas import supports as fused_supports
from coltt_tpu.ops.topk import fetch_scores_ids, scan_topk
from coltt_tpu.utils import msgcodec

_CAPACITY_QUANTUM = 8192
# candidate-count fraction below which the gather regime wins the masked
# scan. Measured (bench_filtered.py, 1M x 768d i8, batch 512, r04 — the
# r03 value 8 was unmeasured): gather/masked QPS 4795/2892 at 5%
# selectivity, 3875/2747 at 12.5%, 2109/2762 at 25% -> crossover ~17%,
# so 1/6 of capacity.
_GATHER_FRACTION = 6

_SNAPSHOT_MAGIC = b"CTTFLAT1"


def _round_capacity(n: int) -> int:
    cap = _CAPACITY_QUANTUM
    while cap < n:
        cap *= 2
    return cap


def _pad_pow2(n: int, lo: int = 128) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _apply_updates_impl(codes, scale, sqnorm, valid, slots, u_codes, u_scale, u_sqnorm, u_valid):
    """One batched scatter applying staged upserts/deletes in place."""
    return (
        codes.at[slots].set(u_codes),
        scale.at[slots].set(u_scale),
        sqnorm.at[slots].set(u_sqnorm),
        valid.at[slots].set(u_valid),
    )


def _apply_pq_codes_impl(pqcodes, slots, u_codes):
    """Scatter staged PQ codes into the authoritative code array."""
    return pqcodes.at[slots].set(u_codes)


def _apply_rr_impl(rr_codes, rr_scale, slots, u_codes, u_scale):
    """Scatter staged rerank-copy rows (BQ mode's f8 shortlist rescorer)."""
    return rr_codes.at[slots].set(u_codes), rr_scale.at[slots].set(u_scale)


# Donating forms update the arrays in place — the serving default (no
# transient double allocation of multi-GB code arrays). Non-donating forms
# exist for sync() while a search snapshot is live: a donated buffer is
# INVALIDATED, and an unlocked concurrent scan still holding the old refs
# would crash with "Array has been deleted". sync() picks per call on the
# store's live-reader count.
_apply_updates = jax.jit(_apply_updates_impl, donate_argnums=(0, 1, 2, 3))
_apply_updates_nd = jax.jit(_apply_updates_impl)
_apply_pq_codes = jax.jit(_apply_pq_codes_impl, donate_argnums=(0,))
_apply_pq_codes_nd = jax.jit(_apply_pq_codes_impl)
_apply_rr = jax.jit(_apply_rr_impl, donate_argnums=(0, 1))
_apply_rr_nd = jax.jit(_apply_rr_impl)


@partial(jax.jit, static_argnames=("k",))
def _gather_search_bq(codes, valid, cand, cand_valid, queries_packed, *, k):
    """BQ variant of the gather regime: gather packed rows, Hamming-scan."""
    g_codes = jnp.take(codes, cand, axis=0)
    g_valid = jnp.take(valid, cand, axis=0) & cand_valid
    negh, local = bq_scan_neg_topk(queries_packed, g_codes, g_valid, k=k)
    return negh, jnp.take(cand, local)


# rows per cache-build block: the reconstruct gather materializes an
# [B*M, dsub] intermediate whose dsub-minor layout lane-pads to 128 lanes —
# the budget below bounds that transient so cache builds run next to a
# fully loaded corpus (B*M*128*4 bytes <= ~800 MB; the budgets here were
# sized for a 16 GB device, ROADMAP D3)
_CACHE_BLOCK = 16384
# per-block reconstruct budget: at M=384 the gather's lane-padded
# [B, M, 128] f32 transient is 100 MB at B=512 — and lax.map double-buffers
# it, so the budget must leave room next to a ~12 GiB codes+cache steady
# state at 10M x 768d on a 16 GB device
_CACHE_TRANSIENT_BYTES = 200 << 20


@partial(jax.jit, static_argnames=("block",))
def _pq_cache_rows(pqcodes, centroids, coarse=None, *, block: int):
    """Reconstruct PQ rows (residual-aware when ``coarse`` is set) and
    re-quantize them into f8 scan-cache form. One dispatch; ``lax.map``
    over row blocks. N % block == 0.

    The per-block scale rides 1-D through the map: a stacked
    ``[nb, block, 1]`` f32 output keeps its lane-padded (128x) layout
    through the reshape — measured ~4 GiB of device memory for what
    should be a 42 MB [10.49M, 1] array; the trailing axis is re-added
    AFTER the clean 1-D reshape (cheap)."""
    n = pqcodes.shape[0]

    def body(cb):
        rec = pq_reconstruct(cb, PQCodebook(centroids, None, coarse))
        codes, scale = quantize(rec, Quantization.F8)
        deq = dequantize(codes, scale)
        return codes, scale.reshape(-1), jnp.sum(deq * deq, axis=1)

    if n == block:
        c8, s8, q8 = body(pqcodes)
        return c8, s8[:, None], q8
    c8, s8, q8 = lax.map(body, pqcodes.reshape(n // block, block, -1))
    return (
        c8.reshape(n, -1),
        s8.reshape(n)[:, None],
        q8.reshape(n),
    )


@partial(jax.jit, static_argnames=("block", "slab"), donate_argnums=(0, 1, 2))
def _fold_cache_slab(c8, s8, q8, pqcodes, centroids, coarse, off, *,
                     slab: int, block: int):
    """Fold one slab of rebuilt cache rows into the preallocated arrays
    (donated, in-place). The slab is sliced INSIDE the jit, so no eager
    copy of the multi-GB code array is made. See _rebuild_pq_cache."""
    pq_slab = lax.dynamic_slice_in_dim(pqcodes, off, slab, axis=0)
    cb, sb, qb = _pq_cache_rows(pq_slab, centroids, coarse, block=block)
    return (
        lax.dynamic_update_slice_in_dim(c8, cb, off, axis=0),
        lax.dynamic_update_slice_in_dim(s8, sb, off, axis=0),
        lax.dynamic_update_slice_in_dim(q8, qb, off, axis=0),
    )


@partial(jax.jit, static_argnames=("block",), donate_argnums=(0, 1, 2))
def _fold_cache_direct(c8, s8, q8, pq_slab, centroids, coarse, off, *,
                       block: int):
    """_fold_cache_slab for a slab passed directly (host-codes mode: the
    slab was just uploaded and there is no device code table to slice)."""
    cb, sb, qb = _pq_cache_rows(pq_slab, centroids, coarse, block=block)
    return (
        lax.dynamic_update_slice_in_dim(c8, cb, off, axis=0),
        lax.dynamic_update_slice_in_dim(s8, sb, off, axis=0),
        lax.dynamic_update_slice_in_dim(q8, qb, off, axis=0),
    )


@partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(buf, part, off):
    """Donated slab write for _upload_rows."""
    return lax.dynamic_update_slice_in_dim(buf, part, off, axis=0)


def _upload_rows(host_arr, *, slab_rows: int = 1 << 20):
    """Host -> device upload of a large row array, slab-wise through a
    donated scatter into a jit-materialized buffer, which bounds the
    transient host and device copies to one slab. (Kept from an
    earlier runtime that retained a relayout copy of single-shot uploads;
    whether a single ``jnp.asarray`` does as well here is ROADMAP D6.)"""
    n = host_arr.shape[0]
    if n <= slab_rows:
        return jnp.asarray(host_arr)
    buf = jnp.zeros(host_arr.shape, host_arr.dtype)
    for off in range(0, n, slab_rows):
        part = jnp.asarray(np.ascontiguousarray(
            host_arr[off:off + slab_rows]))
        buf = _scatter_rows(buf, part, jnp.int32(off))
        jax.block_until_ready(buf)  # bound enqueue overlap + free slabs
    return buf


def _cache_block_for(n: int, m: int = 96) -> int:
    b = _CACHE_BLOCK
    while b > 1024 and b * m * 128 * 4 > _CACHE_TRANSIENT_BYTES:
        b //= 2
    return b if (n > b and n % b == 0) else n


@partial(jax.jit, static_argnames=("k", "metric", "compute_dtype"))
def _gather_search(codes, scale, sqnorm, valid, cand, cand_valid, queries, *, k, metric, compute_dtype):
    """Small-candidate-set regime: gather rows then scan the gathered tile."""
    g_codes = jnp.take(codes, cand, axis=0)
    g_scale = jnp.take(scale, cand, axis=0)
    g_sqnorm = jnp.take(sqnorm, cand, axis=0)
    g_valid = jnp.take(valid, cand, axis=0) & cand_valid
    scores, local = scan_topk(
        queries, g_codes, g_scale, g_sqnorm, g_valid,
        k=k, metric=metric, compute_dtype=compute_dtype,
        block_rows=g_codes.shape[0],
    )
    return scores, jnp.take(cand, local)


@partial(jax.jit, static_argnames=("k", "metric", "compute_dtype"))
def _gather_search_pq(codes, centroids, rotation, coarse, sqnorm, valid, cand,
                      cand_valid, queries, *, k, metric, compute_dtype):
    """PQ variant of the gather regime: gather code rows, ADC-scan the tile."""
    g_codes = jnp.take(codes, cand, axis=0)
    g_sqnorm = jnp.take(sqnorm, cand, axis=0)
    g_valid = jnp.take(valid, cand, axis=0) & cand_valid
    scores, local = pq_scan_topk(
        queries, g_codes, PQCodebook(centroids, rotation, coarse),
        g_sqnorm, g_valid,
        k=k, metric=metric, compute_dtype=compute_dtype,
    )
    return scores, jnp.take(cand, local)


def _locked(fn):
    """Serialize a FlatStore method under the store lock. Edge-mode
    engines release their lock before scanning (engine/edge.py), so the
    store itself must be safe against concurrent search/sync/upsert:
    sync() drains shared staging state and swaps the device arrays —
    unlocked, two searches (each of which syncs) or a search racing an
    upsert could double-apply staged rows or read a torn array set
    (codes new, valid old). RLock: search -> sync re-enters."""
    def wrapper(self, *a, **kw):
        with self._mu:
            return fn(self, *a, **kw)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


class FlatStore:
    """Quantized FLAT store over dense slots. Host object orchestrating
    jitted device functions; all device state is replaced functionally."""

    def __init__(
        self,
        dim: int,
        *,
        metric: Metric = Metric.COSINE,
        quantization: Quantization = Quantization.NONE,
        compute_dtype=None,
        base_capacity: int = _CAPACITY_QUANTUM,
        sharding: Optional[jax.sharding.Sharding] = None,
        mesh: Optional[jax.sharding.Mesh] = None,
        pq_subspaces: Optional[int] = None,
        pq_centroids: int = 256,
        pq_train_iters: int = 15,
        pq_cache: bool = True,
        pq_host_codes: bool = False,  # keep the authoritative PQ codes on
        # the HOST during serving (pq_cache mode only): the device holds
        # only the rebuildable f8 scan cache, and the rerank's shortlist
        # code rows are gathered host-side and uploaded (bytes). The 10M
        # x M=384 configuration REQUIRES this on a 16 GB chip: codes +
        # cache don't co-reside with working transients (VERDICT r4 #2's
        # "evict authoritative codes to host during serving").
        pq_opq_iters: int = 0,  # >0: OPQ rotation (ops/pq.py PQCodebook doc)
        pq_coarse: int = 0,     # >0: residual mode — whole-vector coarse
        # quantizer of that many centroids; codes carry a 2-byte cid
        # prefix (ops/pq.py module doc). The big recall lever at 10M.
        bq_rerank: bool = True,
        bq_oversample: int = 64,
        bq_rerank_dtype=Quantization.BF16,
    ):
        self._mu = threading.RLock()
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.quantization = Quantization.parse(quantization)
        self.is_pq = self.quantization == Quantization.PQ
        self.is_bq = self.quantization == Quantization.BQ
        self.pq_cache = bool(pq_cache) and self.is_pq
        self.pq_host = bool(pq_host_codes) and self.pq_cache
        # BQ (the reserved Quantization_BQ both protos declare; ops/bq.py):
        # codes are packed sign bits [cap, ceil(D/32)] uint32 — 32x smaller
        # than f32. With bq_rerank (default) an f8 copy reranks the Hamming
        # shortlist of k*bq_oversample rows back to ~f8 ranking quality;
        # without it, search ranks on the Hamming angle estimate alone
        # (96 bytes/row at 768d — the memory-minimal mode).
        self.bq_rerank = bool(bq_rerank) and self.is_bq
        self.bq_oversample = int(bq_oversample)
        # rerank-copy precision: bf16 default (measured 0.98 recall@10 on a
        # tight-margin clustered corpus where f8 reranking plateaus at 0.81
        # — within-cluster cosine gaps sit below f8's ~2 significant
        # digits); f8 halves the copy for a recall trade.
        self.bq_rr_quant = Quantization.parse(bq_rerank_dtype)
        if self.is_bq and self.bq_rr_quant not in (
            Quantization.BF16, Quantization.F16, Quantization.F8
        ):
            raise ValueError("bq_rerank_dtype must be bf16/f16/f8")
        if self.is_bq and self.metric != Metric.COSINE:
            raise ValueError("BQ quantization is cosine-only (sign bits carry no magnitude)")
        if self.is_pq:
            # PQ path (the reference's reserved Quantization_PQ; ops.pq):
            # authoritative codes are [cap, M] uint8 nearest-centroid ids,
            # the codebook is trained lazily on the first synced batch.
            #
            # Decompress-at-search ADC is gather-bound, far from the
            # bandwidth bound for large N. With pq_cache=True (default)
            # the store therefore decompresses ONCE per mutation into an
            # f8 scan cache ([cap, D] f8 + per-row scale) and search rides
            # the same fused scan as F8 mode — codes stay
            # the snapshot/source-of-truth, the cache is rebuildable state.
            # pq_cache=False keeps the low-memory blockwise-ADC scan.
            self._qdtype = jnp.uint8
            self.pq_m = int(pq_subspaces or default_subspaces(self.dim))
            if self.dim % self.pq_m != 0:
                raise ValueError(
                    f"dim {self.dim} not divisible by pq_subspaces={self.pq_m}"
                )
            self.pq_centroids = int(pq_centroids)
            self.pq_train_iters = int(pq_train_iters)
            self.pq_opq_iters = int(pq_opq_iters)
            self.pq_coarse = int(pq_coarse)
            # residual codes carry the uint16 coarse id as a 2-byte prefix
            self.pq_width = self.pq_m + (2 if self.pq_coarse else 0)
            self.codebook: Optional[PQCodebook] = None
            self._row_width = self.pq_width
        elif self.is_bq:
            self._qdtype = jnp.uint32
            self._row_width = bq_words(self.dim)
        else:
            self._qdtype = storage_dtype(self.quantization)
            self._row_width = self.dim
        # "arithmetic in fp32" parity: unquantized stores scan at full f32
        # precision; quantized stores scan in bf16 (their codes carry less
        # information than bf16 anyway, so the bf16 tensor-core path is
        # free).
        if compute_dtype is None:
            compute_dtype = (
                jnp.float32 if self.quantization == Quantization.NONE else jnp.bfloat16
            )
        self.compute_dtype = compute_dtype
        # mesh > 1 device: row arrays live sharded P(shard) over the mesh
        # and every full scan routes through the shard_map collective path
        # (parallel/dist_search.py) — the reference's goroutine-per-shard
        # scan (edge/f16_vectorstore.go:138-170) as devices instead of
        # goroutines, INSIDE the store the engines serve (VERDICT r4 #1).
        self.mesh = mesh
        if sharding is None and mesh is not None and mesh.size > 1:
            from coltt_tpu.parallel.mesh import shard_spec
            sharding = shard_spec(mesh)
        self.sharding = sharding

        cap = _round_capacity(max(base_capacity, _CAPACITY_QUANTUM))
        self._alloc(cap)

        self.pk_to_slot: Dict[str, int] = {}
        self.slot_to_pk: Dict[int, str] = {}
        self._free: List[int] = []
        self._next_slot = 0

        # staged mutations: slot -> (f32 row | None for delete)
        self._pending: Dict[int, Optional[np.ndarray]] = {}
        # live unlocked-search snapshots (see search / sync donation note)
        self._readers = 0

    # -- device state ------------------------------------------------------
    @property
    def _scan_shape(self):
        """(width, dtype) of ``self.codes``, the array search scans."""
        if self.pq_cache:
            return self.dim, jnp.float8_e4m3fn
        return self._row_width, self._qdtype

    def _pq_code_array(self):
        """The authoritative [cap, M] uint8 PQ codes (PQ mode only).
        numpy in host-codes mode, device array otherwise."""
        if self.pq_host:
            return self.pqcodes_host
        return self.pqcodes if self.pq_cache else self.codes

    def _alloc(self, cap: int) -> None:
        width, dtype = self._scan_shape
        self.codes = self._put(jnp.zeros((cap, width), dtype))
        if self.pq_host:
            self.pqcodes = None
            self.pqcodes_host = np.zeros((cap, self.pq_width), np.uint8)
        else:
            self.pqcodes = (
                self._put(jnp.zeros((cap, self.pq_width), jnp.uint8))
                if self.pq_cache
                else None
            )
            self.pqcodes_host = None
        if self.bq_rerank:
            self.rr_codes = self._put(
                jnp.zeros((cap, self.dim), storage_dtype(self.bq_rr_quant))
            )
            self.rr_scale = self._put(jnp.ones((cap, 1), jnp.float32))
        else:
            self.rr_codes = self.rr_scale = None
        self.scale = self._put(jnp.ones((cap, 1), jnp.float32))
        self.sqnorm = self._put(jnp.zeros((cap,), jnp.float32))
        self.valid = self._put(jnp.zeros((cap,), jnp.bool_))
        self.capacity = cap

    def _put(self, x):
        return jax.device_put(x, self.sharding) if self.sharding is not None else x

    def _grow(self, need: int) -> None:
        new_cap = _round_capacity(need)
        pad = new_cap - self.capacity
        width, dtype = self._scan_shape
        self.codes = self._put(
            jnp.concatenate([self.codes, jnp.zeros((pad, width), dtype)])
        )
        if self.pq_host:
            self.pqcodes_host = np.concatenate(
                [self.pqcodes_host,
                 np.zeros((pad, self.pq_width), np.uint8)]
            )
        elif self.pq_cache:
            self.pqcodes = self._put(
                jnp.concatenate(
                    [self.pqcodes, jnp.zeros((pad, self.pq_width), jnp.uint8)]
                )
            )
        if self.bq_rerank:
            self.rr_codes = self._put(
                jnp.concatenate(
                    [self.rr_codes,
                     jnp.zeros((pad, self.dim), storage_dtype(self.bq_rr_quant))]
                )
            )
            self.rr_scale = self._put(
                jnp.concatenate([self.rr_scale, jnp.ones((pad, 1), jnp.float32)])
            )
        self.scale = self._put(
            jnp.concatenate([self.scale, jnp.ones((pad, 1), jnp.float32)])
        )
        self.sqnorm = self._put(
            jnp.concatenate([self.sqnorm, jnp.zeros((pad,), jnp.float32)])
        )
        self.valid = self._put(
            jnp.concatenate([self.valid, jnp.zeros((pad,), jnp.bool_)])
        )
        self.capacity = new_cap

    # -- mutation ----------------------------------------------------------
    def _take_slot(self) -> int:
        if self._free:
            return self._free.pop()
        slot = self._next_slot
        self._next_slot += 1
        if self._next_slot > self.capacity:
            self._grow(self._next_slot)
        return slot

    @_locked
    def upsert(self, pk: str, vector: np.ndarray) -> int:
        """Insert or overwrite by primary key (ChangedVertex parity,
        edge/f16_vectorstore.go:67-107)."""
        vec = np.asarray(vector, np.float32).reshape(-1)
        if vec.shape[0] != self.dim:
            raise ValueError(
                f"dimension mismatch: got {vec.shape[0]}, collection dim {self.dim}"
            )
        slot = self.pk_to_slot.get(pk)
        if slot is None:
            slot = self._take_slot()
            self.pk_to_slot[pk] = slot
            self.slot_to_pk[slot] = pk
        self._pending[slot] = vec
        return slot

    @_locked
    def upsert_many(self, pks, vectors) -> List[int]:
        """Bulk upsert: one staging pass, one scatter at next sync. The bulk
        path the reference lacks (its gRPC Insert is one-by-one; SURVEY.md §6
        notes 1M inserts take ~600s there)."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(
                f"expected [N, {self.dim}] vectors, got {vectors.shape}"
            )
        if len(pks) != vectors.shape[0]:
            raise ValueError("pks/vectors length mismatch")
        slots = []
        for pk, vec in zip(pks, vectors):
            slot = self.pk_to_slot.get(pk)
            if slot is None:
                slot = self._take_slot()
                self.pk_to_slot[pk] = slot
                self.slot_to_pk[slot] = pk
            self._pending[slot] = vec
            slots.append(slot)
        return slots

    @_locked
    def bulk_build(self, pks, vectors) -> None:
        """Device-side bulk ingest for initial corpus load.

        ``vectors`` may be a device array; rows never round-trip through
        host staging (the reference's only ingest is one-by-one gRPC
        Insert — ~600 s for 1M rows, SURVEY.md §6 — and even our staged
        ``upsert_many`` pays a host stack + transfer; this path quantizes /
        PQ-trains / encodes entirely on device). Only valid on an empty
        store.
        """
        if len(self.pk_to_slot) or self._pending or self._free:
            raise RuntimeError("bulk_build requires an empty store")
        vectors = jnp.asarray(vectors, jnp.float32)
        n, d = vectors.shape
        if d != self.dim:
            raise ValueError(f"expected [N, {self.dim}] vectors, got {vectors.shape}")
        if len(pks) != n:
            raise ValueError("pks/vectors length mismatch")
        cap = max(_round_capacity(n), self.capacity)
        pad = [(0, cap - n), (0, 0)]

        if self.is_pq:
            if self.codebook is None:
                self.codebook = train_pq(
                    vectors, m=self.pq_m, n_centroids=self.pq_centroids,
                    iters=self.pq_train_iters, opq_iters=self.pq_opq_iters,
                    coarse_centroids=self.pq_coarse,
                )
            # pad to capacity FIRST so encode/cache blocks divide evenly
            # (cap is a power-of-two multiple of the quantum); padding rows
            # are masked by valid below
            v_pad = jnp.pad(vectors, pad)
            u_pq, u_lut_sqnorm = pq_encode(v_pad, self.codebook)
            if self.pq_cache:
                if self.pq_host:
                    self.pqcodes_host = np.asarray(jax.device_get(u_pq))
                else:
                    self.pqcodes = self._put(u_pq)
                codes, scale, sqnorm = _pq_cache_rows(
                    u_pq, self.codebook.centroids, self.codebook.coarse,
                    block=_cache_block_for(cap, self.pq_m),
                )
            else:
                codes, scale, sqnorm = (
                    u_pq, jnp.ones((cap, 1), jnp.float32), u_lut_sqnorm,
                )
            self.codes = self._put(codes)
            self.scale = self._put(scale)
            self.sqnorm = self._put(sqnorm)
        elif self.is_bq:
            self.codes = self._put(jnp.pad(bq_encode(vectors), pad))
            if self.bq_rerank:
                rr, rr_s = quantize(vectors, self.bq_rr_quant)
                self.rr_codes = self._put(jnp.pad(rr, pad))
                self.rr_scale = self._put(
                    jnp.pad(rr_s, pad, constant_values=1.0)
                )
            # scale/sqnorm are unused by the Hamming scan; keep shapes in
            # step with the new capacity for the shared scatter path
            self.scale = self._put(jnp.ones((cap, 1), jnp.float32))
            self.sqnorm = self._put(jnp.zeros((cap,), jnp.float32))
        else:
            codes, scale = quantize(vectors, self.quantization)
            codes = codes.astype(self._qdtype)
            deq = dequantize(codes, scale)
            sqnorm = jnp.sum(deq * deq, axis=1)
            self.codes = self._put(jnp.pad(codes, pad))
            self.scale = self._put(jnp.pad(scale, pad, constant_values=1.0))
            self.sqnorm = self._put(jnp.pad(sqnorm, pad[:1]))
        self.valid = self._put(
            jnp.pad(jnp.ones((n,), jnp.bool_), pad[:1])
        )
        self.capacity = cap
        self._next_slot = n
        self.pk_to_slot = dict(zip(pks, range(n)))
        self.slot_to_pk = dict(enumerate(pks))

    @_locked
    def delete(self, pk: str) -> Optional[int]:
        """Tombstone + free the slot (RemoveVertex parity,
        edge/f16_vectorstore.go:108-130)."""
        slot = self.pk_to_slot.pop(pk, None)
        if slot is None:
            return None
        self.slot_to_pk.pop(slot, None)
        self._pending[slot] = None
        self._free.append(slot)
        return slot

    @_locked
    def sync(self) -> None:
        """Apply staged mutations in one batched scatter. Batch is padded to
        a power-of-two bucket so jit recompiles stay bounded."""
        if not self._pending:
            return
        # while search snapshots are live, the old buffers must survive the
        # scatter — use the non-donating forms (transient double allocation
        # of the touched arrays, only during a mutate-vs-search interleave)
        donate = self._readers == 0
        apply_updates = _apply_updates if donate else _apply_updates_nd
        apply_pq = _apply_pq_codes if donate else _apply_pq_codes_nd
        apply_rr = _apply_rr if donate else _apply_rr_nd
        items = sorted(self._pending.items())
        self._pending = {}
        slots = np.array([s for s, _ in items], np.int32)
        rows = np.stack(
            [np.zeros(self.dim, np.float32) if v is None else v for _, v in items]
        )
        alive = np.array([v is not None for _, v in items], bool)

        n = len(slots)
        padded = _pad_pow2(n)
        if padded != n:
            # duplicate the first entry; duplicate scatter of identical rows
            # is idempotent
            slots = np.concatenate([slots, np.full(padded - n, slots[0], np.int32)])
            rows = np.concatenate([rows, np.repeat(rows[:1], padded - n, axis=0)])
            alive = np.concatenate([alive, np.full(padded - n, alive[0])])

        if self.is_pq:
            if self.codebook is None and alive.any():
                # lazy train on the first synced batch (documented PQ
                # contract: the first ingest is the training sample)
                self.codebook = train_pq(
                    jnp.asarray(rows[alive]),
                    m=self.pq_m,
                    n_centroids=self.pq_centroids,
                    iters=self.pq_train_iters,
                    opq_iters=self.pq_opq_iters,
                    coarse_centroids=self.pq_coarse,
                )
            if self.codebook is None:  # all-deletes batch before any data
                u_pq = jnp.zeros((len(slots), self.pq_width), jnp.uint8)
                u_lut_sqnorm = jnp.zeros((len(slots),), jnp.float32)
            else:
                u_pq, u_lut_sqnorm = pq_encode(jnp.asarray(rows), self.codebook)
            if self.pq_cache:
                if self.codebook is None:
                    u_codes = jnp.zeros((len(slots), self.dim), jnp.float8_e4m3fn)
                    u_scale = jnp.ones((len(slots), 1), jnp.float32)
                    u_sqnorm = u_lut_sqnorm
                else:
                    u_codes, u_scale, u_sqnorm = _pq_cache_rows(
                        u_pq, self.codebook.centroids, self.codebook.coarse,
                        block=_cache_block_for(u_pq.shape[0], self.pq_m),
                    )
                if self.pq_host:
                    # authoritative codes live host-side: one fetch of the
                    # freshly encoded batch, scattered into the host array
                    self.pqcodes_host[slots] = np.asarray(
                        jax.device_get(u_pq)
                    )
                else:
                    self.pqcodes = apply_pq(
                        self.pqcodes, jnp.asarray(slots), u_pq
                    )
            else:
                u_codes = u_pq
                u_sqnorm = u_lut_sqnorm
                u_scale = jnp.ones((len(slots), 1), jnp.float32)
        elif self.is_bq:
            j_rows = jnp.asarray(rows)
            u_codes = bq_encode(j_rows)
            u_scale = jnp.ones((len(slots), 1), jnp.float32)
            u_sqnorm = jnp.zeros((len(slots),), jnp.float32)
            if self.bq_rerank:
                rr, rr_s = quantize(j_rows, self.bq_rr_quant)
                self.rr_codes, self.rr_scale = apply_rr(
                    self.rr_codes, self.rr_scale, jnp.asarray(slots), rr, rr_s
                )
        else:
            u_codes, u_scale = quantize(jnp.asarray(rows), self.quantization)
            u_codes = u_codes.astype(self._qdtype)
            deq = dequantize(u_codes, u_scale)
            u_sqnorm = jnp.sum(deq * deq, axis=1)
        self.codes, self.scale, self.sqnorm, self.valid = apply_updates(
            self.codes, self.scale, self.sqnorm, self.valid,
            jnp.asarray(slots), u_codes, u_scale, u_sqnorm, jnp.asarray(alive),
        )

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.pk_to_slot)

    @property
    def memory_bytes(self) -> int:
        """DEVICE bytes per the store (host-resident code tables excluded)."""
        per_row = (
            self._row_width * jnp.dtype(self._qdtype).itemsize + 4 + 4 + 1
        )
        if self.pq_host:
            per_row -= self._row_width  # codes live on the host
        if self.pq_cache:
            per_row += self.dim  # f8 scan cache
        if self.bq_rerank:
            per_row += (
                self.dim * jnp.dtype(storage_dtype(self.bq_rr_quant)).itemsize + 4
            )  # rerank copy + scale
        return self.capacity * per_row

    @_locked
    def get_vector(self, pk: str) -> Optional[np.ndarray]:
        slot = self.pk_to_slot.get(pk)
        if slot is None:
            return None
        pend = self._pending.get(slot)
        if pend is not None:
            return pend.copy()
        self.sync()
        if self.is_pq:
            if self.codebook is None:
                return None
            pq_codes = self._pq_code_array()
            return np.asarray(
                jax.device_get(pq_reconstruct(pq_codes[slot : slot + 1],
                                              self.codebook, derotate=True))
            )[0]
        if self.is_bq:
            if self.bq_rerank:
                row = jax.device_get(self.rr_codes[slot]).astype(np.float32)
                return row * float(jax.device_get(self.rr_scale[slot])[0])
            return np.asarray(
                jax.device_get(bq_decode(self.codes[slot : slot + 1], self.dim))
            )[0]
        row = jax.device_get(self.codes[slot]).astype(np.float32)
        return row * float(jax.device_get(self.scale[slot])[0])

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        candidates: Optional[np.ndarray] = None,
        metric: Optional[Metric] = None,
        approx_recall: Optional[float] = None,
        fused: bool = False,
        oversample: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k scan. Returns ``(scores [Q,k], slots [Q,k])``; empty slots
        carry score -inf. ``candidates`` is an optional dense int32 array of
        allowed slots (from the inverted index) — the filtered path.
        ``approx_recall`` selects ApproxTopK at that recall target (~4x
        scan throughput at 0.99 on 1M x 768; see ops.topk). ``fused``
        selects the Pallas fused scan kernel (ops/scan_pallas.py — the
        int8 tensor-core path when the store is I8-quantized; falls back to the
        XLA path where the kernel's shape rules don't hold).
        ``oversample > 1`` widens a shortlist-then-rerank mode: on a
        PQ-cache store it shortlists k*oversample rows from the f8 cache
        and re-scores them against the exact PQ reconstruction
        (ops/pq.py pq_rerank_neg_topk); on a BQ store it overrides the
        store's ``bq_oversample`` for the Hamming shortlist (full-scan
        and filtered paths alike). Other modes ignore it, and BQ ignores
        ``fused``/``approx_recall`` (the Hamming scan is its own kernel).

        Locking: only sync() + a snapshot of the device-array references
        run under the store lock; the scan itself runs outside it, so
        concurrent searches overlap and upserts are not blocked for the
        scan's duration (the edge engine's release-lock-before-scan
        design, engine/edge.py). Device arrays are immutable — a
        concurrent sync() swaps the ORIGINAL store's refs, never the
        snapshot's — and the live-reader count makes concurrent syncs use
        non-donating scatters so the snapshot's buffers stay alive."""
        with self._mu:
            self.sync()
            self._readers += 1
            snap = copy.copy(self)  # shallow: shares immutable array refs
        try:
            return snap._search_unlocked(
                queries, k, candidates=candidates, metric=metric,
                approx_recall=approx_recall, fused=fused,
                oversample=oversample,
            )
        finally:
            with self._mu:
                self._readers -= 1

    def _search_unlocked(
        self,
        queries: np.ndarray,
        k: int,
        *,
        candidates: Optional[np.ndarray] = None,
        metric: Optional[Metric] = None,
        approx_recall: Optional[float] = None,
        fused: bool = False,
        oversample: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """search() body on an already-synced snapshot (see search)."""
        metric = self.metric if metric is None else Metric.parse(metric)
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != collection dim {self.dim}"
            )
        k = max(1, int(k))
        if (self.pq_cache and self.codebook is not None
                and self.codebook.rotation is not None):
            # the f8 scan cache stores OPQ-rotated reconstructions; rotate
            # queries to match. Stays a device array — pulling it back to
            # host would add a full device round trip per search.
            queries = self.codebook.rotate(jnp.asarray(queries))

        sharded = self.mesh is not None and self.mesh.size > 1
        if candidates is not None:
            candidates = np.asarray(candidates, np.int32).reshape(-1)
            if candidates.size == 0:
                q = queries.shape[0]
                return (
                    np.full((q, k), -np.inf, np.float32),
                    np.full((q, k), -1, np.int32),
                )
            # sharded stores always take the masked scan: the gather regime
            # would pull candidate rows across shards, defeating the
            # shard-local scan + tiny-merge layout
            if not sharded and candidates.size < max(
                k, self.capacity // _GATHER_FRACTION
            ):
                return self._search_gathered(
                    queries, candidates, k, metric, oversample=oversample
                )
            mask = np.zeros(self.capacity, bool)
            mask[candidates] = True
            valid = self.valid & jnp.asarray(mask)
        else:
            valid = self.valid

        if sharded:
            return self._search_sharded(
                queries, valid, k, metric,
                approx_recall=approx_recall, fused=fused,
                oversample=oversample,
            )

        if self.is_bq:
            if metric != Metric.COSINE:
                raise ValueError("BQ collections are cosine-only")
            return self._search_bq(queries, valid, k, oversample)

        if self.is_pq and not self.pq_cache:
            if self.codebook is None:  # nothing ever synced
                q = queries.shape[0]
                return (
                    np.full((q, k), -np.inf, np.float32),
                    np.full((q, k), -1, np.int32),
                )
            scores, slots = pq_scan_topk(
                jnp.asarray(queries), self.codes, self.codebook, self.sqnorm,
                valid, k=min(k, self.capacity), metric=metric,
                compute_dtype=self.compute_dtype,
            )
        elif self.pq_cache and self.codebook is not None and oversample > 1:
            # big stores get a barrier between scan and rerank (below) and
            # keep the AUTO scan blocks, so the two stages' buffers never
            # overlap next to a large resident store (the threshold was
            # sized for a 16 GB device, ROADMAP D3)
            big = self.memory_bytes > (6 << 30)
            # f8-cache shortlist -> exact-reconstruction rerank (queries
            # were already rotated above; rotation=None here). The
            # shortlist honors the ``fused`` kernel request when the cache
            # shape supports it — high_resource searches on PQ collections
            # keep the Pallas path.
            from coltt_tpu.ops.pq import pq_rerank_neg_topk
            from coltt_tpu.ops.scan_pallas import fused_scan_neg_topk
            from coltt_tpu.ops.topk import scan_neg_topk
            from coltt_tpu.ops.score import normalize_score

            shortlist = min(k * oversample, self.capacity)
            if fused and fused_supports(
                self.capacity, self.dim, metric, self.codes.dtype
            ):
                negd, slots = fused_scan_neg_topk(
                    jnp.asarray(queries), self.codes, self.scale, self.sqnorm,
                    valid, k=shortlist, metric=metric,
                    compute_dtype=self.compute_dtype,
                )
            else:
                negd, slots = scan_neg_topk(
                    jnp.asarray(queries), self.codes, self.scale, self.sqnorm,
                    valid, k=shortlist, metric=metric,
                    compute_dtype=self.compute_dtype,
                    approx_recall=approx_recall,
                )
            if self.pq_host:
                # host-resident codes: fetch the (raw) shortlist in one
                # round trip, gather the code rows on the HOST, upload
                # them (bytes) and rescore on device. The device never
                # holds the multi-GB code table — serving state is the f8
                # cache alone (the 10M x M=384 configuration of a 16 GB
                # device)
                from coltt_tpu.ops.pq import pq_rescore_rows

                nh, ih = fetch_scores_ids(negd, slots)
                crow = self.pqcodes_host[
                    np.where(ih >= 0, ih, 0).reshape(-1)
                ]
                negd, slots = pq_rescore_rows(
                    jnp.asarray(queries), jnp.asarray(nh), jnp.asarray(ih),
                    jnp.asarray(crow), self.codebook.centroids,
                    k=min(k, self.capacity), metric=metric,
                    coarse=self.codebook.coarse,
                )
            else:
                if big:
                    # big-store mode: a barrier between the shortlist scan
                    # and the rerank — with both executables in flight
                    # their enqueue-time allocations overlap, and next to
                    # a ~12 GiB resident store that overlap OOMs
                    # (measured: each stage alone fits; enqueued together
                    # they don't)
                    jax.block_until_ready(negd)
                negd, slots = pq_rerank_neg_topk(
                    jnp.asarray(queries), negd, slots, self.pqcodes,
                    self.codebook.centroids, k=min(k, self.capacity),
                    metric=metric, coarse=self.codebook.coarse,
                )
                if big:
                    jax.block_until_ready(negd)  # see scan barrier note
            scores = jnp.where(
                jnp.isinf(negd), -jnp.inf, normalize_score(-negd, metric)
            )
        else:
            # serving hot path: upload queries as f16 when the store is
            # quantized — half the host->device bytes (ROADMAP A8 measures
            # whether that still pays); f16 carries ~3 decimal digits, well
            # above the int8/f8/bf16 scan's own query quantization.
            # NONE-quant stores keep full f32 queries.
            q_up = queries
            if (isinstance(queries, np.ndarray)
                    and queries.dtype == np.float32
                    and self.quantization != Quantization.NONE):
                q_up = queries.astype(np.float16)
            # transfer in the (possibly f16) wire dtype and widen ON DEVICE
            # — jnp.asarray(x, jnp.float32) would convert on the host and
            # transfer f32, forfeiting the halved host->device payload
            jq = jnp.asarray(q_up).astype(jnp.float32)
            if fused and fused_supports(
                self.capacity, self.dim, metric, self.codes.dtype
            ):
                scores, slots = fused_scan_topk(
                    jq, self.codes, self.scale, self.sqnorm,
                    valid, k=min(k, self.capacity), metric=metric,
                    compute_dtype=self.compute_dtype,
                )
            else:
                scores, slots = scan_topk(
                    jq, self.codes, self.scale, self.sqnorm, valid,
                    k=min(k, self.capacity), metric=metric,
                    compute_dtype=self.compute_dtype,
                    block_rows=self._serving_block_rows(
                        np.atleast_2d(queries).shape[0]
                    ),
                    approx_recall=approx_recall,
                )
        s_host, i_host = fetch_scores_ids(scores, slots)
        return self._trim(s_host, i_host, k)

    def _serving_block_rows(self, q: int):
        """Row-block override for big stores (None = op default).

        The op-level auto block budget assumes a mostly-empty device; on a
        16 GB device a 10M x 768d PQ store holds ~12.2 GiB resident, and
        serving overlaps several in-flight scans (each with its own
        executable temp arena). Cap the per-block transient
        (scores + double-buffered dequant) at ~128 MB so a depth-8 search
        pipeline stays within ~1 GB of arenas."""
        if self.memory_bytes < (6 << 30):
            return None
        per_row = (
            q * 4 + 2 * self.dim * jnp.dtype(self.compute_dtype).itemsize
        )
        target = max(_CAPACITY_QUANTUM,
                     ((128 << 20) // per_row)
                     // _CAPACITY_QUANTUM * _CAPACITY_QUANTUM)
        b = min(target, self.capacity)
        while self.capacity % b:
            b -= _CAPACITY_QUANTUM  # terminates: capacity % QUANTUM == 0
        return b

    def _search_sharded(self, queries, valid, k, metric, *,
                        approx_recall=None, fused=False, oversample=1):
        """Full-scan search over a mesh: shard-local scan + collective
        merge (parallel/dist_search.py). PQ-cache queries arrive already
        OPQ-rotated (caller); the PQ rerank therefore runs with
        rotation=None against the rotated code space, exactly like the
        single-device path."""
        from coltt_tpu.parallel.dist_search import (
            sharded_bq_topk,
            sharded_pq_topk,
            sharded_scan_topk,
        )
        from coltt_tpu.parallel.mesh import BATCH_AXIS, batch_spec

        mesh = self.mesh
        q = np.atleast_2d(queries).shape[0]
        batch = mesh.shape.get(BATCH_AXIS, 1)
        jq = jnp.asarray(queries, jnp.float32)
        pad = (-q) % batch
        if pad:
            jq = jnp.concatenate(
                [jq, jnp.zeros((pad, self.dim), jnp.float32)], axis=0
            )
        jq = jax.device_put(jq, batch_spec(mesh))

        if self.is_bq:
            if metric != Metric.COSINE:
                raise ValueError("BQ collections are cosine-only")
            ovs = oversample if oversample > 1 else (
                self.bq_oversample if self.bq_rerank else 1
            )
            scores, slots = sharded_bq_topk(
                mesh, self.codes, valid,
                self.rr_codes if self.bq_rerank else None, jq,
                k=min(k, self.capacity), oversample=ovs, dim=self.dim,
            )
        elif self.is_pq and not self.pq_cache:
            if self.codebook is None:
                return (
                    np.full((q, k), -np.inf, np.float32),
                    np.full((q, k), -1, np.int32),
                )
            scores, slots = sharded_pq_topk(
                mesh, self.codes, self.codebook.centroids, self.sqnorm,
                valid, jq, k=min(k, self.capacity), metric=metric,
                compute_dtype=self.compute_dtype,
                rotation=self.codebook.rotation,
                coarse=self.codebook.coarse,
            )
        else:
            pq_rr = None
            if (self.pq_cache and self.codebook is not None
                    and oversample > 1 and not self.pq_host):
                # host-resident codes can't ride the shard-local rerank
                # (no device code table); sharded + pq_host serves the
                # f8-cache ranking directly
                pq_rr = (self.pqcodes, self.codebook.centroids,
                         self.codebook.coarse)
            scores, slots = sharded_scan_topk(
                mesh, self.codes, self.scale, self.sqnorm, valid, jq,
                k=min(k, self.capacity), metric=metric,
                compute_dtype=self.compute_dtype,
                approx_recall=approx_recall, fused=fused,
                oversample=oversample, pq_rerank=pq_rr,
            )
        s_host, i_host = fetch_scores_ids(scores, slots)
        s_host, i_host = s_host[:q], i_host[:q]
        return self._trim(s_host, i_host, k)

    def _search_bq(self, queries, valid, k: int, oversample: int):
        """BQ search: Hamming shortlist over the packed bits, then (by
        default) an f8 rerank of the gathered shortlist. ``oversample=1``
        (the generic default) uses the store's ``bq_oversample``."""
        qj = jnp.asarray(queries, jnp.float32)
        qp = bq_encode(qj)
        ovs = oversample if oversample > 1 else (
            self.bq_oversample if self.bq_rerank else 1
        )
        shortlist = min(k * max(ovs, 1), self.capacity)
        # no-rerank stores serve the Hamming values directly — force exact
        # per-block selection (see bq_scan_neg_topk approximation note)
        negh, slots = bq_scan_neg_topk(qp, self.codes, valid, k=shortlist,
                                       exact=not self.bq_rerank)
        return self._finish_bq(qj, negh, slots, k)

    def _finish_bq(self, qj, negh, slots, k: int):
        from coltt_tpu.ops.score import normalize_score
        from coltt_tpu.ops.topk import rerank_neg_topk

        if self.bq_rerank:
            negd, slots = rerank_neg_topk(
                qj, negh, slots, self.rr_codes, self.rr_scale,
                k=min(k, negh.shape[1]), metric=Metric.COSINE,
                compute_dtype=self.compute_dtype,
            )
        else:
            kk = min(k, negh.shape[1])
            negd, slots = negh[:, :kk], slots[:, :kk]
            negd = hamming_to_neg_cos_dist(negd, self.dim)
        scores = jnp.where(
            jnp.isinf(negd), -jnp.inf, normalize_score(-negd, Metric.COSINE)
        )
        s_host, i_host = fetch_scores_ids(scores, slots)
        return self._trim(s_host, i_host, k)

    def _search_gathered(self, queries, candidates, k, metric, *,
                         oversample: int = 1):
        n = candidates.size
        padded = _pad_pow2(max(n, k))
        cand = np.zeros(padded, np.int32)
        cand[:n] = candidates
        cand_valid = np.zeros(padded, bool)
        cand_valid[:n] = True
        if self.is_bq:
            if metric != Metric.COSINE:
                raise ValueError("BQ collections are cosine-only")
            qj = jnp.asarray(queries, jnp.float32)
            qp = bq_encode(qj)
            ovs = oversample if oversample > 1 else (
                self.bq_oversample if self.bq_rerank else 1
            )
            shortlist = min(k * max(ovs, 1), padded)
            negh, slots = _gather_search_bq(
                self.codes, self.valid, jnp.asarray(cand),
                jnp.asarray(cand_valid), qp, k=shortlist,
            )
            return self._finish_bq(qj, negh, slots, k)
        if self.is_pq and not self.pq_cache:
            if self.codebook is None:
                q = np.atleast_2d(queries).shape[0]
                return (
                    np.full((q, k), -np.inf, np.float32),
                    np.full((q, k), -1, np.int32),
                )
            scores, slots = _gather_search_pq(
                self.codes, self.codebook.centroids, self.codebook.rotation,
                self.codebook.coarse, self.sqnorm, self.valid,
                jnp.asarray(cand), jnp.asarray(cand_valid), jnp.asarray(queries),
                k=min(k, padded), metric=metric, compute_dtype=self.compute_dtype,
            )
        else:
            scores, slots = _gather_search(
                self.codes, self.scale, self.sqnorm, self.valid,
                jnp.asarray(cand), jnp.asarray(cand_valid), jnp.asarray(queries),
                k=min(k, padded), metric=metric, compute_dtype=self.compute_dtype,
            )
        s_host, i_host = fetch_scores_ids(scores, slots)
        return self._trim(s_host, i_host, k)

    @staticmethod
    def _trim(scores, slots, k):
        if scores.shape[1] < k:
            q = scores.shape[0]
            pad = k - scores.shape[1]
            scores = np.concatenate(
                [scores, np.full((q, pad), -np.inf, np.float32)], axis=1
            )
            slots = np.concatenate([slots, np.full((q, pad), -1, np.int32)], axis=1)
        slots = np.where(np.isneginf(scores), -1, slots)
        return scores, slots

    # -- persistence -------------------------------------------------------
    _SAVE_ROWS = 131_072  # rows fetched per device->host chunk on save

    @staticmethod
    def _write_rows(f, arr, step=_SAVE_ROWS) -> None:
        """Stream a (device or host) array to ``f`` in row chunks, so the
        host never holds more than one chunk + the file buffer — a 10M-row
        PQ/BQ collection flushes without materializing the multi-GB array
        (VERDICT r3: the one-shot device_get+tobytes spiked ~3x payload)."""
        n = arr.shape[0]
        for i in range(0, n, step):
            f.write(np.asarray(jax.device_get(arr[i:i + step])).tobytes())

    @_locked
    def save(self, f: io.BufferedIOBase) -> None:
        """Binary snapshot (SaveVertex parity, edge/f16_vectorstore.go:317+).
        Layout: magic, msgpack header, then raw array bytes (streamed in
        row chunks — see _write_rows)."""
        self.sync()
        header = {
            "dim": self.dim,
            "metric": int(self.metric),
            "quantization": int(self.quantization),
            "capacity": self.capacity,
            "next_slot": self._next_slot,
            "free": self._free,
            "pks": [[pk, slot] for pk, slot in self.pk_to_slot.items()],
        }
        if self.is_bq:
            header["bq"] = {
                "rerank": self.bq_rerank,
                "oversample": self.bq_oversample,
                "rerank_dtype": int(self.bq_rr_quant),
            }
        if self.is_pq:
            cb = io.BytesIO()
            if self.codebook is not None:
                self.codebook.save(cb)
            header["pq"] = {
                "m": self.pq_m,
                "centroids": self.pq_centroids,
                "train_iters": self.pq_train_iters,
                "opq_iters": self.pq_opq_iters,
                "coarse": self.pq_coarse,
                "cache": self.pq_cache,
                "codebook": cb.getvalue(),
            }
        hb = msgcodec.packb(header)
        f.write(_SNAPSHOT_MAGIC)
        f.write(len(hb).to_bytes(8, "big"))
        f.write(hb)
        codes = self._pq_code_array() if self.is_pq else self.codes
        for arr in (codes, self.scale, self.sqnorm, self.valid):
            self._write_rows(f, arr)
        if self.bq_rerank:
            # the sign bits are lossy; the rerank copy is authoritative
            # extra state, not rebuildable — snapshot it alongside
            self._write_rows(f, self.rr_codes)
            self._write_rows(f, self.rr_scale)

    @classmethod
    def load(
        cls,
        f: io.BufferedIOBase,
        *,
        sharding: Optional[jax.sharding.Sharding] = None,
        mesh: Optional[jax.sharding.Mesh] = None,
        pq_cache: Optional[bool] = None,
        pq_host_codes: Optional[bool] = None,  # None = auto: host-resident
        # codes for PQ-cache collections whose code table exceeds 2 GB
    ) -> "FlatStore":
        magic = f.read(len(_SNAPSHOT_MAGIC))
        if magic != _SNAPSHOT_MAGIC:
            raise ValueError("not a FlatStore snapshot")
        hlen = int.from_bytes(f.read(8), "big")
        header = msgcodec.unpackb(f.read(hlen))
        pq = header.get("pq")
        bq = header.get("bq")
        if pq_cache is None:
            pq_cache = pq.get("cache", True) if pq else True
        if pq_host_codes is None:
            pq_host_codes = bool(
                pq and pq_cache
                and header["capacity"] * (pq["m"] + (2 if pq.get("coarse")
                                                    else 0)) > (2 << 30)
            )
        store = cls(
            header["dim"],
            metric=Metric.parse(header["metric"]),
            quantization=Quantization.parse(header["quantization"]),
            # minimum-capacity construction: a full-capacity _alloc would
            # put ~11 GB of zeros on device at 10M rows only to be
            # replaced by the loaded arrays below — a transient that OOMs
            # next to them. Every row array is reassigned before use;
            # capacity is fixed up right after.
            base_capacity=_CAPACITY_QUANTUM,
            sharding=sharding,
            mesh=mesh,
            pq_subspaces=pq["m"] if pq else None,
            pq_centroids=pq["centroids"] if pq else 256,
            pq_train_iters=pq["train_iters"] if pq else 15,
            pq_opq_iters=pq.get("opq_iters", 0) if pq else 0,
            pq_coarse=pq.get("coarse", 0) if pq else 0,
            pq_cache=pq_cache,
            pq_host_codes=pq_host_codes,
            bq_rerank=bq.get("rerank", True) if bq else True,
            bq_oversample=bq.get("oversample", 64) if bq else 64,
            bq_rerank_dtype=Quantization.parse(
                bq.get("rerank_dtype", int(Quantization.BF16))
            ) if bq else Quantization.BF16,
        )
        if pq and pq["codebook"]:
            store.codebook = PQCodebook.load(io.BytesIO(pq["codebook"]))
        cap = header["capacity"]
        store.capacity = cap
        width = store._row_width
        qdt = np.dtype(store._qdtype)
        codes = np.frombuffer(f.read(cap * width * qdt.itemsize), qdt).reshape(
            cap, width
        )
        scale = np.frombuffer(f.read(cap * 4), np.float32).reshape(cap, 1)
        sqnorm = np.frombuffer(f.read(cap * 4), np.float32)
        valid = np.frombuffer(f.read(cap), np.bool_)
        store.valid = store._put(jnp.asarray(valid))
        if store.pq_host:
            # host-resident codes (the 10M x M=384 configuration): the
            # code table never goes to the device — writable host copy
            # (frombuffer views are read-only) + slab-wise cache rebuild
            store.pqcodes_host = np.array(codes)
            store._rebuild_pq_cache()
            jax.block_until_ready(store.codes)
        elif store.pq_cache:
            # slab-wise upload (see _upload_rows), then a barrier before
            # the rebuild so the enqueue-time buffer spike of
            # upload+rebuild never overlaps
            store.pqcodes = store._put(_upload_rows(codes))
            jax.block_until_ready(store.pqcodes)
            store._rebuild_pq_cache()
            jax.block_until_ready(store.codes)
        elif store.is_pq:
            store.codes = store._put(jnp.asarray(codes))
            store.scale = store._put(jnp.ones((cap, 1), jnp.float32))
            store.sqnorm = store._put(
                pq_sqnorm(store.codes, store.codebook)
                if store.codebook is not None
                else jnp.zeros((cap,), jnp.float32)
            )
        else:
            store.codes = store._put(jnp.asarray(codes))
            store.scale = store._put(jnp.asarray(scale))
            store.sqnorm = store._put(jnp.asarray(sqnorm))
        if store.bq_rerank:
            f8 = np.dtype(storage_dtype(store.bq_rr_quant))
            d = store.dim
            rr = np.frombuffer(f.read(cap * d * f8.itemsize), f8).reshape(cap, d)
            rr_s = np.frombuffer(f.read(cap * 4), np.float32).reshape(cap, 1)
            store.rr_codes = store._put(jnp.asarray(rr))
            store.rr_scale = store._put(jnp.asarray(rr_s))
        store._next_slot = header["next_slot"]
        store._free = list(header["free"])
        store.pk_to_slot = {pk: slot for pk, slot in header["pks"]}
        store.slot_to_pk = {slot: pk for pk, slot in header["pks"]}
        return store

    @classmethod
    def adopt_pq(
        cls,
        codebook: PQCodebook,
        pqcodes,
        *,
        pks=None,
        metric: Metric = Metric.COSINE,
        cache=None,      # optional prebuilt (codes f8, scale, sqnorm)
        pq_cache: bool = True,
        pq_host_codes: bool = False,
        mesh: Optional[jax.sharding.Mesh] = None,
    ) -> "FlatStore":
        """Adopt pre-encoded PQ codes as a live store — the streaming
        bulk-ingest path for corpora whose f32 form exceeds HBM (a 10M x
        768d corpus is 30 GB f32 vs 3.9 GB M=384 codes; callers encode
        slab-wise with ops.pq.pq_encode and hand the code rows here; cf.
        DistributedFlatIndex.from_bq_codes). ``cache`` passes an
        already-built f8 scan cache to avoid rebuilding it; otherwise the
        cache is rebuilt from the codes (blocked, transient-bounded).
        ``pqcodes.shape[0]`` must be a multiple of the 8192-row capacity
        quantum; ``pks`` defaults to stringified row indices.
        ``pq_host_codes=True`` keeps the code table on the host (pqcodes
        should then be a numpy array; see the constructor note)."""
        if not pq_host_codes:
            pqcodes = jnp.asarray(pqcodes)
        n, cw = pqcodes.shape
        if n % _CAPACITY_QUANTUM:
            raise ValueError(
                f"adopt_pq needs rows % {_CAPACITY_QUANTUM} == 0, got {n}"
            )
        coarse_c = (
            int(codebook.coarse.shape[0]) if codebook.coarse is not None else 0
        )
        m = cw - (2 if coarse_c else 0)
        if m != codebook.m:
            raise ValueError(
                f"code width {cw} does not match codebook "
                f"(m={codebook.m}, coarse={coarse_c})"
            )
        dim = codebook.m * codebook.dsub
        # construct at the minimum capacity (a full-capacity constructor
        # would _alloc ~11 GB of zeros at 10M rows just to be replaced —
        # a transient that alone OOMs next to the adopted arrays), then
        # adopt the real arrays and fix up capacity
        store = cls(
            dim,
            metric=metric,
            quantization=Quantization.PQ,
            base_capacity=_CAPACITY_QUANTUM,
            pq_subspaces=m,
            pq_centroids=codebook.n_centroids,
            pq_coarse=coarse_c,
            pq_cache=pq_cache,
            pq_host_codes=pq_host_codes,
            mesh=mesh,
        )
        store.capacity = n
        store.codebook = codebook
        if store.pq_cache:
            if store.pq_host:
                store.pqcodes_host = np.ascontiguousarray(
                    np.asarray(pqcodes, np.uint8)
                )
            else:
                store.pqcodes = store._put(pqcodes)
            if cache is not None:
                c8, s8, q8 = cache
                store.codes = store._put(c8)
                store.scale = store._put(s8)
                store.sqnorm = store._put(q8)
            else:
                store._rebuild_pq_cache()
        else:
            store.codes = store._put(pqcodes)
            store.scale = store._put(jnp.ones((n, 1), jnp.float32))
            store.sqnorm = store._put(pq_sqnorm(pqcodes, codebook))
        store.valid = store._put(jnp.ones(n, bool))
        if pks is None:
            pks = [str(i) for i in range(n)]
        store.pk_to_slot = {pk: i for i, pk in enumerate(pks)}
        store.slot_to_pk = {i: pk for i, pk in enumerate(pks)}
        store._next_slot = n
        return store

    _REBUILD_SLAB = 1 << 20  # rows folded per donated scatter step

    def _rebuild_pq_cache(self) -> None:
        """Decompress the authoritative PQ codes into the f8 scan cache
        (one-time per load).

        Host-driven slab loop + donated scatters, not one giant lax.map
        dispatch: the donation pattern updates the preallocated arrays in
        place with a bounded per-slab transient. (An earlier runtime
        kept a whole-store map executable's buffers resident; whether one
        dispatch would do here is ROADMAP D6.)"""
        if self.codebook is None:
            return
        cap = self.capacity
        slab = min(cap, self._REBUILD_SLAB)
        while cap % slab:
            slab -= _CAPACITY_QUANTUM  # terminates: cap % QUANTUM == 0
        c8 = self._put(jnp.zeros((cap, self.dim), jnp.float8_e4m3fn))
        s8 = self._put(jnp.zeros((cap, 1), jnp.float32))
        q8 = self._put(jnp.zeros((cap,), jnp.float32))
        block = _cache_block_for(slab, self.pq_m)
        for off in range(0, cap, slab):
            if self.pq_host:
                # host-resident codes: upload one slab transiently
                part = jnp.asarray(self.pqcodes_host[off:off + slab])
                c8, s8, q8 = _fold_cache_direct(
                    c8, s8, q8, part,
                    self.codebook.centroids, self.codebook.coarse,
                    jnp.int32(off), block=block,
                )
            else:
                c8, s8, q8 = _fold_cache_slab(
                    c8, s8, q8, self.pqcodes,
                    self.codebook.centroids, self.codebook.coarse,
                    jnp.int32(off), slab=slab, block=block,
                )
            # bound enqueue-time buffer overlap (the same hazard the
            # snapshot-load barrier documents)
            jax.block_until_ready(c8)
        self.codes = c8
        self.scale = s8
        self.sqnorm = q8
