"""Product quantization: codebook training, encoding, ADC top-k search.

Reference parity: the reference *reserved* PQ — ``Quantization_PQ`` in
``idl/proto/v3/core.proto``, the second distance library ``pkg/distancepq``
(``puredist.go:20-38`` squared-euclidean/dot, ``distance.go:87-97`` registry)
and the legacy PQ parameter structs ``pkg/models/hnsw_common.go`` — but never
shipped an implementation (SURVEY.md §7 phase 9). Its 2024.11 releases did
ship an earlier PQ (HNSW+PQ, <14 ms @ 50k) that was later removed. This
module is the accelerator-native realization of that reserved path.

Design. Classic CPU ADC builds a per-query LUT and gathers
``M`` table entries per stored row — a scalar-gather loop that maps terribly
onto matrix units. Here:

- **Training** is batched Lloyd's iterations over *all* ``M`` subspaces at
  once: assignment is one ``[M, S, dsub] x [M, K, dsub] -> [M, S, K]``
  batched matmul (argmin over centroids), and the centroid update is the
  transposed one-hot matmul ``[M, K, S] x [M, S, dsub]`` — both matmul work,
  chunked over the sample axis to bound memory. No data-dependent Python;
  one ``lax.scan`` over chunks inside a ``lax.fori_loop`` over iterations.
- **Encoding** is the same batched assignment matmul, blocked over rows.
- **Search** decompresses blocks *through the codebook gather* and feeds the
  standard fused scan: reconstruct ``[B, D]`` in bf16 (a ``take_along_axis``
  on the ``[K, M, dsub]`` table — B*M gathered subvectors), then the one
  ``[Q, D] x [B, D] -> [Q, B]`` contraction from ops.distance. For
  dot-decomposable metrics this is *numerically identical* to LUT-ADC
  (the reconstructed vector is exactly the concatenation of centroids), but
  the arithmetic rides the tensor cores instead of a gather per (row,
  subspace, query). Stored-row norms are exact via the centroid-norm LUT:
  ``||v_hat||^2 = sum_m ||c[m, code]||^2``.

Codes are ``[N, M] uint8`` — with M = D/8 subspaces that is 8 bytes per
96 float32s, a 32x-96x device-memory reduction over f8/none (BASELINE.json
config #4 serves a 10M x 768d corpus this way).

**Residual (coarse+PQ) mode** (``train_pq(coarse_centroids=C)``): a
whole-vector k-means coarse quantizer (up to 65536 centroids, trained on
device with the same batched Lloyd) absorbs the corpus's cluster
structure, and the PQ codebook encodes only the residual ``x - g_cid`` —
the IVFPQ encoding WITHOUT the inverted-list routing, so search remains
the same full fused scan (same QPS) while reconstruction error drops with
the residual energy (on cluster-mixture data, most of it). The coarse id
rides as two leading uint8 bytes in each code row (``[N, 2+M]``), so
every consumer that treats codes as an opaque byte matrix — snapshots,
sharding, dynamic_update_slice — is unchanged; only encode/reconstruct/
rerank interpret the layout (keyed off ``codebook.coarse``). Measured at
10M x 768d (bench_pq.py, cluster-mixture corpus): recall@10 0.714 (plain,
M=192) vs 0.730 for coarse=16384 + M=96 residual at HALF the durable
bytes per row, and 0.825 for coarse + M=192 (README table; the earlier
0.94 figure here was wrong — it contradicted the measured sweep).
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from coltt_tpu.ops.distance import Metric, scan_distances
from coltt_tpu.utils import msgcodec

_CODEBOOK_MAGIC = b"CTTPQCB1"

# sample rows per Lloyd chunk: [M, CHUNK, K] f32 transient stays ~0.4 GB at
# M=96, K=256
_TRAIN_CHUNK = 4096
# rows per encode block: bounds the [M, B, K] f32 assignment transient
# (~1.6 GB at M=96, K=256, B=16384) inside the single-dispatch lax.map
_ENCODE_BLOCK = 16384
# cap on that transient: at higher M (dsub=4 -> M=D/4) the block shrinks
# so encoding can run next to a fully loaded corpus
_ENCODE_TRANSIENT_BYTES = 1 << 30


def _encode_block_for(n: int, m: int, n_centroids: int) -> int:
    b = _ENCODE_BLOCK
    # floor 2048 (was 4096): at M=384 (dsub=2) a 4096-row block's [M, B, K]
    # assignment transient is 1.6 GB — too much next to an 11.6 GB
    # codes+cache steady state at 10M x 768d
    while b > 2048 and m * b * n_centroids * 4 > _ENCODE_TRANSIENT_BYTES:
        b //= 2
    # any N is fine: _encode_all runs full blocks through lax.map and the
    # remainder through one static tail block (never the unblocked path —
    # that reinstated the transient this cap exists to bound)
    return min(b, n)
# rows per search block: the reconstructed [B, D] bf16 tile (~200 MB at 768d)
_SEARCH_BLOCK = 131_072


_COARSE_BYTES = 2       # uint16 cid packed big-endian into the code prefix
_COARSE_MAX = 1 << 16   # cid must fit the two prefix bytes
# rows per coarse-assignment block: bounds the [B, C] f32 score transient
# (~512 MB at C=16384)
_COARSE_ASSIGN_BLOCK = 8192


def _split_cid(codes):
    """Packed residual codes [.., 2+M] -> (cid [..] int32, pq [.., M])."""
    cid = (codes[..., 0].astype(jnp.int32) << 8) | codes[..., 1].astype(
        jnp.int32)
    return cid, codes[..., _COARSE_BYTES:]


@partial(jax.jit, static_argnames=("block",))
def _coarse_assign(x, coarse, *, block: int):
    """Nearest coarse centroid per row (L2), blocked over rows."""
    csq = jnp.sum(coarse * coarse, axis=1)

    def body(xb):
        sims = 2.0 * (xb @ coarse.T) - csq[None, :]
        return jnp.argmax(sims, axis=1).astype(jnp.int32)

    n = x.shape[0]
    if n <= block:
        return body(x)
    nb = n // block
    main = lax.map(body, x[: nb * block].reshape(nb, block, -1)).reshape(-1)
    if n % block:
        return jnp.concatenate([main, body(x[nb * block:])])
    return main


@jax.jit
def _coarse_lloyd_step(xs, cents):
    """One whole-vector Lloyd iteration (assignment matmul + one-hot
    update), scanning row blocks to bound the [B, C] transient. Empty
    clusters keep their centroid."""
    c = cents.shape[0]
    csq = jnp.sum(cents * cents, axis=1)
    blk = min(8192, xs.shape[0])
    nb = xs.shape[0] // blk

    def body(carry, xb):
        sums, cnt = carry
        sims = 2.0 * (xb @ cents.T) - csq[None, :]
        oh = (
            jnp.argmax(sims, axis=1)[:, None] == jnp.arange(c)[None, :]
        ).astype(jnp.float32)
        return (sums + oh.T @ xb, cnt + jnp.sum(oh, axis=0)), 0

    (sums, cnt), _ = lax.scan(
        body,
        (jnp.zeros((c, xs.shape[1]), jnp.float32), jnp.zeros(c, jnp.float32)),
        xs[: nb * blk].reshape(nb, blk, -1),
    )
    if xs.shape[0] % blk:
        xb = xs[nb * blk:]
        sims = 2.0 * (xb @ cents.T) - csq[None, :]
        oh = (
            jnp.argmax(sims, axis=1)[:, None] == jnp.arange(c)[None, :]
        ).astype(jnp.float32)
        sums = sums + oh.T @ xb
        cnt = cnt + jnp.sum(oh, axis=0)
    return jnp.where(cnt[:, None] > 0, sums / jnp.maximum(cnt, 1.0)[:, None],
                     cents)


def default_subspaces(dim: int, target_dsub: int = 8) -> int:
    """Largest M <= dim/target_dsub that divides dim (dsub >= 2)."""
    m = max(1, dim // target_dsub)
    while m > 1 and dim % m != 0:
        m -= 1
    return m


@jax.tree_util.register_pytree_node_class
@dataclass
class PQCodebook:
    """Trained product-quantization codebook.

    centroids: ``[M, K, dsub] float32`` — K centroids per subspace.
    rotation: optional ``[D, D]`` orthonormal OPQ rotation (Ge et al. 2013,
    "Optimized Product Quantization", the non-parametric alternation).
    When set, encoding quantizes ``x @ R`` and every stored/reconstructed
    vector lives in the rotated space; dot/cosine are rotation-invariant,
    so search only needs the query rotated once ([Q, D] x [D, D] — noise
    next to the scan). OPQ balances variance across subspaces, which is
    what rescues PQ recall on anisotropic (real-embedding-like) data:
    measured on 262k x 128d spectrum-decay+cluster data, plain PQ
    recall@10 0.32 -> OPQ 0.62 (os=1); with os=4 + bf16 rerank 0.83 ->
    0.98 (see bench_pq.py for the serving-scale numbers).
    """

    centroids: jax.Array
    rotation: Optional[jax.Array] = None
    # residual mode: [C, D] whole-vector coarse centroids (rotated space);
    # PQ centroids then encode x - coarse[cid] and each code row carries
    # the uint16 cid in its two leading bytes
    coarse: Optional[jax.Array] = None

    def tree_flatten(self):
        return (self.centroids, self.rotation, self.coarse), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2])

    @property
    def code_width(self) -> int:
        """Bytes per stored code row (cid prefix + M subspace codes)."""
        return self.m + (_COARSE_BYTES if self.coarse is not None else 0)

    def rotate(self, x: jax.Array) -> jax.Array:
        """Project into the codebook's space (identity when no OPQ)."""
        if self.rotation is None:
            return x
        return jnp.matmul(x, self.rotation, precision=lax.Precision.HIGHEST)

    def derotate(self, x: jax.Array) -> jax.Array:
        if self.rotation is None:
            return x
        return jnp.matmul(x, self.rotation.T, precision=lax.Precision.HIGHEST)

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub

    @property
    def centroid_sqnorm(self) -> jax.Array:
        """``[M, K]`` squared norms of each centroid (the norm LUT)."""
        return jnp.sum(self.centroids * self.centroids, axis=-1)

    # -- persistence --------------------------------------------------------
    def save(self, f: io.BufferedIOBase) -> None:
        cents = np.asarray(jax.device_get(self.centroids), np.float32)
        header = {"m": int(cents.shape[0]), "k": int(cents.shape[1]),
                  "dsub": int(cents.shape[2]),
                  "opq": self.rotation is not None,
                  "coarse": (0 if self.coarse is None
                             else int(self.coarse.shape[0]))}
        hb = msgcodec.packb(header)
        f.write(_CODEBOOK_MAGIC)
        f.write(len(hb).to_bytes(8, "big"))
        f.write(hb)
        f.write(cents.tobytes())
        if self.rotation is not None:
            f.write(np.asarray(jax.device_get(self.rotation),
                               np.float32).tobytes())
        if self.coarse is not None:
            f.write(np.asarray(jax.device_get(self.coarse),
                               np.float32).tobytes())

    @classmethod
    def load(cls, f: io.BufferedIOBase) -> "PQCodebook":
        magic = f.read(len(_CODEBOOK_MAGIC))
        if magic != _CODEBOOK_MAGIC:
            raise ValueError("not a PQ codebook snapshot")
        hlen = int.from_bytes(f.read(8), "big")
        h = msgcodec.unpackb(f.read(hlen))
        m, k, dsub = h["m"], h["k"], h["dsub"]
        cents = np.frombuffer(f.read(m * k * dsub * 4), np.float32)
        rot = None
        d = m * dsub
        if h.get("opq"):
            rot = jnp.asarray(
                np.frombuffer(f.read(d * d * 4), np.float32).reshape(d, d)
            )
        coarse = None
        c = h.get("coarse", 0)
        if c:
            coarse = jnp.asarray(
                np.frombuffer(f.read(c * d * 4), np.float32).reshape(c, d)
            )
        return cls(jnp.asarray(cents.reshape(m, k, dsub)), rot, coarse)


def _sub_assign(x_sub, centroids, csq):
    """Nearest centroid per (row, subspace).

    x_sub ``[M, C, dsub]``, centroids ``[M, K, dsub]`` -> ``[M, C] int32``.
    Squared L2 argmin drops the ||x||^2 term (constant in k).
    """
    dots = lax.dot_general(
        x_sub, centroids,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [M, C, K]
    return jnp.argmin(csq[:, None, :] - 2.0 * dots, axis=-1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_centroids", "iters", "chunk"))
def _lloyd(x_sub, init, *, n_centroids: int, iters: int, chunk: int):
    """Batched Lloyd's over all subspaces. x_sub: [M, S, dsub], S % chunk == 0."""
    m, s, dsub = x_sub.shape
    xc = jnp.moveaxis(
        x_sub.reshape(m, s // chunk, chunk, dsub), 1, 0
    )  # [nchunk, M, chunk, dsub]

    def iteration(_, cents):
        csq = jnp.sum(cents * cents, axis=-1)

        def chunk_body(carry, xb):  # xb [M, chunk, dsub]
            sums, counts = carry
            assign = _sub_assign(xb, cents, csq)  # [M, chunk]
            oh = jax.nn.one_hot(assign, n_centroids, dtype=jnp.float32)
            sums = sums + lax.dot_general(
                oh, xb,
                dimension_numbers=(((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )  # [M, K, dsub]
            counts = counts + jnp.sum(oh, axis=1)  # [M, K]
            return (sums, counts), None

        zero_s = jnp.zeros((m, n_centroids, dsub), jnp.float32)
        zero_c = jnp.zeros((m, n_centroids), jnp.float32)
        (sums, counts), _ = lax.scan(chunk_body, (zero_s, zero_c), xc)
        new = sums / jnp.maximum(counts, 1.0)[..., None]
        # empty clusters keep their previous centroid
        return jnp.where((counts > 0)[..., None], new, cents)

    return lax.fori_loop(0, iters, iteration, init)


def train_pq(
    vectors,
    *,
    m: Optional[int] = None,
    n_centroids: int = 256,
    iters: int = 15,
    sample_size: int = 65_536,
    key: Optional[jax.Array] = None,
    opq_iters: int = 0,
    coarse_centroids: int = 0,
    coarse_iters: int = 10,
) -> PQCodebook:
    """Train a PQ codebook on (a sample of) ``vectors [N, D] float32``.

    ``opq_iters > 0`` adds the OPQ non-parametric alternation (Ge et al.
    2013): each round re-runs a few Lloyd iterations on the rotated
    sample, then solves the orthogonal Procrustes problem
    ``min_R ||X R - X_hat||_F`` via SVD for a new rotation. The rotation
    is initialized from the sample's PCA eigenvectors (which alone gets
    most of the benefit on anisotropic data).

    ``coarse_centroids > 0`` enables residual mode (module docstring):
    after the rotation settles, a whole-vector k-means of that many
    centroids (<= 65536) is trained on the rotated sample and the PQ
    codebook is re-fit on the sample's coarse residuals.
    """
    if coarse_centroids < 0 or coarse_centroids > _COARSE_MAX:
        raise ValueError(
            f"coarse_centroids must be 0..{_COARSE_MAX} (uint16 cid prefix)"
        )
    x = jnp.asarray(vectors, jnp.float32)
    n, dim = x.shape
    if m is None:
        m = default_subspaces(dim)
    if dim % m != 0:
        raise ValueError(f"dim {dim} not divisible by m={m} subspaces")
    if n_centroids > 256:
        raise ValueError("n_centroids > 256 does not fit uint8 codes")
    dsub = dim // m
    key = jax.random.PRNGKey(0) if key is None else key

    s = min(n, sample_size)
    s = max(_TRAIN_CHUNK, (s // _TRAIN_CHUNK) * _TRAIN_CHUNK) if s >= _TRAIN_CHUNK else s
    kperm, kinit = jax.random.split(key)
    if s < n:
        rows = jax.random.choice(kperm, n, (s,), replace=False)
        sample = jnp.take(x, rows, axis=0)
    else:
        sample = x

    rotation = None
    if opq_iters > 0:
        # PCA init: eigvecs of the sample covariance (host-side numpy SVD —
        # a one-time [D, D] solve)
        xs = np.asarray(jax.device_get(sample))
        cov = (xs.T @ xs) / max(len(xs) - 1, 1)
        _, vecs_ = np.linalg.eigh(cov)
        # interleave eigendirections across subspaces round-robin so each
        # subspace gets comparable variance (eigenvalue allocation):
        # eigvec i (desc) -> subspace i % m, slot i // m
        desc = vecs_[:, ::-1]
        i = np.arange(dim)
        pos = (i % m) * dsub + (i // m)
        perm = np.empty(dim, np.int64)
        perm[pos] = i
        rotation = jnp.asarray(np.ascontiguousarray(desc[:, perm]),
                               jnp.float32)
        sample_r = sample @ rotation
    else:
        sample_r = sample

    k = min(n_centroids, s)

    def fit(smp, lloyd_iters):
        x_sub = jnp.moveaxis(smp.reshape(s, m, dsub), 0, 1)
        init_rows = jax.random.choice(kinit, s, (k,), replace=False)
        init = jnp.take(x_sub, init_rows, axis=1)
        chunk = min(_TRAIN_CHUNK, s)
        if s % chunk != 0:
            chunk = s
        return _lloyd(x_sub, init, n_centroids=k, iters=lloyd_iters,
                      chunk=chunk)

    cents = fit(sample_r, iters)
    for _ in range(max(0, opq_iters - 1)):
        codes, _ = _encode_all(
            sample_r, cents, jnp.sum(cents * cents, axis=-1),
            block=_encode_block_for(s, m, k),
        )
        # Procrustes: min_R ||sample R - xhat||, R orthonormal. X^T X_hat
        # is accumulated in row blocks: the reconstruction gather's
        # lane-padded intermediate is ~16x the block bytes (flat.py
        # _CACHE_BLOCK note), which unblocked OOMs next to a loaded corpus.
        blk = 8192
        mmat = jnp.zeros((dim, dim), jnp.float32)
        for st in range(0, s, blk):
            xh = _reconstruct(codes[st:st + blk], cents, jnp.float32)
            mmat = mmat + sample[st:st + blk].T @ xh
        u, _, vt = np.linalg.svd(np.asarray(jax.device_get(mmat)))
        rotation = jnp.asarray((u @ vt).astype(np.float32))
        sample_r = sample @ rotation
        cents = fit(sample_r, iters)

    coarse = None
    if coarse_centroids:
        c = min(coarse_centroids, s)
        kc = jax.random.fold_in(kinit, 1)
        init_rows = jax.random.choice(kc, s, (c,), replace=False)
        coarse = jnp.take(sample_r, init_rows, axis=0)
        for _ in range(max(1, coarse_iters)):
            coarse = _coarse_lloyd_step(sample_r, coarse)
        cid = _coarse_assign(sample_r, coarse,
                             block=_COARSE_ASSIGN_BLOCK)
        # re-fit the subspace codebook on the residual distribution —
        # that is where the codes' bits now go
        cents = fit(sample_r - jnp.take(coarse, cid, axis=0), iters)

    if k < n_centroids:  # pad so codes stay uint8-dense and shapes static
        pad = jnp.repeat(cents[:, :1], n_centroids - k, axis=1)
        cents = jnp.concatenate([cents, pad], axis=1)
    return PQCodebook(cents, rotation, coarse)


@partial(jax.jit, static_argnames=("block",))
def _encode_all(x, centroids, csq, *, block: int):
    """[N, D] -> ([N, M] uint8, [N] f32). One dispatch: ``lax.map`` over
    row blocks bounds the [M, B, K] assignment transient; any N — full
    blocks via the map plus one static remainder block."""
    n, dim = x.shape
    m, _, dsub = centroids.shape

    def body(xb):  # [B, D]
        x_sub = jnp.moveaxis(
            xb.reshape(xb.shape[0], m, dsub), 0, 1
        )  # [M, B, dsub]
        return _sub_assign(x_sub, centroids, csq).T  # [B, M]

    nb = n // block
    parts = []
    if nb:
        parts.append(
            lax.map(
                body, x[: nb * block].reshape(nb, block, dim)
            ).reshape(nb * block, m)
        )
    if n % block:
        parts.append(body(x[nb * block:]))
    codes = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    sqnorm = _sqnorm_from_codes(codes, csq.T, block)
    return codes.astype(jnp.uint8), sqnorm


def pq_encode(vectors, codebook: PQCodebook) -> Tuple[jax.Array, jax.Array]:
    """Encode ``[N, D]`` -> ``(codes [N, code_width] uint8, sqnorm [N] f32)``.

    ``sqnorm`` is the exact squared norm of the *reconstruction* (the value
    the fused scan needs) — via the centroid-norm LUT in plain mode, via a
    blocked reconstruct in residual mode (the coarse/PQ cross term defeats
    the LUT). With an OPQ rotation the input is rotated first; codes and
    reconstructions live in the rotated space (dot/cosine are invariant —
    scans rotate the query). In residual mode the first two bytes of each
    code row carry the uint16 coarse id. Callers feed chunked inputs at
    10M scale (the [N, D] residual is a transient of the input's size).
    """
    x = codebook.rotate(jnp.asarray(vectors, jnp.float32))
    n = x.shape[0]
    block = _encode_block_for(n, codebook.m, codebook.n_centroids)
    if codebook.coarse is None:
        return _encode_all(
            x, codebook.centroids, codebook.centroid_sqnorm, block=block
        )
    cid = _coarse_assign(x, codebook.coarse, block=_COARSE_ASSIGN_BLOCK)
    resid = x - jnp.take(codebook.coarse, cid, axis=0)
    pq_c, _ = _encode_all(
        resid, codebook.centroids, codebook.centroid_sqnorm, block=block
    )
    codes = jnp.concatenate(
        [
            (cid >> 8).astype(jnp.uint8)[:, None],
            (cid & 0xFF).astype(jnp.uint8)[:, None],
            pq_c,
        ],
        axis=1,
    )
    sqnorm = _recon_sqnorm_blocked(
        codes, codebook.centroids, codebook.coarse, block=block
    )
    return codes, sqnorm


#: cap on the reconstruct gather's lane-padded [B, M, 128] transient —
#: take_along_axis pads dsub to 128 lanes, a 64x inflation at dsub=2, so
#: at M=384 an unblocked 16384-row reconstruct is 3.2 GB (what OOM'd the
#: 10M dsub=2 serving leg next to its 12.3 GB codes+cache steady state)
#: 128 MB: sized for a 16 GB device, where after a ~12 GiB store loads
#: free memory is fragmented — a block transient must fit a contiguous
#: HOLE, not just the free total (ROADMAP D3 re-derives it)
_RECON_TRANSIENT_BYTES = 1 << 27


def _recon_block_for(n: int, m: int, itemsize: int = 4) -> int:
    b = _ENCODE_BLOCK
    while b > 512 and b * m * 128 * itemsize > _RECON_TRANSIENT_BYTES:
        b //= 2
    return min(b, n) if n else b


@partial(jax.jit, static_argnames=("block",))
def _recon_sqnorm_blocked(codes, centroids, coarse, *, block: int):
    """||reconstruction||^2 for residual codes, blocked over rows."""
    n = codes.shape[0]

    def body(cb):
        rec = _reconstruct(cb, centroids, jnp.float32, coarse=coarse)
        return jnp.sum(rec * rec, axis=1)

    if n <= block:
        return body(codes)
    nb = n // block
    main = lax.map(
        body, codes[: nb * block].reshape(nb, block, -1)
    ).reshape(-1)
    if n % block:
        return jnp.concatenate([main, body(codes[nb * block:])])
    return main


def _sqnorm_from_codes(codes, csq_t, block: int):
    """LUT-sum of centroid sqnorms, blocked over rows (any N — full blocks
    via ``lax.map`` plus a static remainder block). The int32 upcast +
    gather transient is ~8 bytes/code, ~8 GB at 10M x 96 unblocked."""
    n = codes.shape[0]

    def body(cb):
        return jnp.sum(jnp.take_along_axis(csq_t, cb.astype(jnp.int32),
                                           axis=0), axis=1)

    if n <= block:
        return body(codes)
    nb = n // block
    main = lax.map(body, codes[: nb * block].reshape(nb, block, -1)).reshape(-1)
    if n % block:
        return jnp.concatenate([main, body(codes[nb * block:])])
    return main


@partial(jax.jit, static_argnames=("block",))
def _sqnorm_blocked(codes, csq_t, *, block):
    return _sqnorm_from_codes(codes, csq_t, block)


def pq_sqnorm(codes, codebook: PQCodebook, *, block: int = _ENCODE_BLOCK
              ) -> jax.Array:
    """Exact squared reconstruction norms for code rows, blocked over rows
    (memory-safe at any N). LUT-summed in plain mode, reconstructed in
    residual mode (the cross term defeats the LUT)."""
    if codebook.coarse is not None:
        return _recon_sqnorm_blocked(
            codes, codebook.centroids, codebook.coarse,
            block=min(block, codes.shape[0],
                      _recon_block_for(codes.shape[0], codebook.m)),
        )
    return _sqnorm_blocked(codes, codebook.centroid_sqnorm.T, block=block)


def pq_reconstruct(codes, codebook: PQCodebook, *, derotate: bool = False
                   ) -> jax.Array:
    """Decode code rows -> ``[N, D] float32`` (centroid concatenation, plus
    the coarse centroid in residual mode).

    The result lives in the codebook's (possibly OPQ-rotated) space;
    ``derotate=True`` maps back to the original coordinates (for
    user-facing vector readback)."""
    rec = _reconstruct(codes, codebook.centroids, jnp.float32,
                       coarse=codebook.coarse)
    return codebook.derotate(rec) if derotate else rec


def _reconstruct(codes, centroids, dtype, coarse=None):
    """[N, M] (or [N, 2+M] residual) uint8 codes -> [N, D] ``dtype``."""
    cid = None
    if coarse is not None:
        cid, codes = _split_cid(codes)
    n, m = codes.shape
    _, _, dsub = centroids.shape
    table = jnp.moveaxis(centroids, 0, 1).astype(dtype)  # [K, M, dsub]
    rec = jnp.take_along_axis(
        table, codes.astype(jnp.int32)[..., None], axis=0
    )  # [N, M, dsub]
    rec = rec.reshape(n, m * dsub)
    if coarse is not None:
        rec = rec + jnp.take(coarse, cid, axis=0).astype(dtype)
    return rec


@partial(
    jax.jit,
    static_argnames=("k", "metric", "compute_dtype", "block_rows"),
)
def pq_scan_neg_topk(
    queries,
    codes,
    centroids,
    sqnorm,
    valid,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
    block_rows: Optional[int] = None,
    rotation=None,
    coarse=None,
):
    """ADC top-k over PQ codes: ``(negdist [Q,k], ids [Q,k])``.

    Blocks the row axis; each block is reconstructed through the codebook
    gather in ``compute_dtype`` and scanned with the shared fused
    matmul+epilogue, then block-local top-k partials merge — the same
    local-heap-then-merge shape as ops.topk.scan_neg_topk. ``rotation``
    (OPQ) is applied to the queries; codes already live rotated. The
    default block adapts to M so the lane-padded reconstruct transient
    (B*M*128 lanes) stays bounded at any subspace count.
    """
    metric = Metric.parse(metric)
    queries = jnp.asarray(queries, jnp.float32)
    if rotation is not None:
        # scores depend on it: full f32 (a GPU runs f32 matmuls as TF32
        # by default)
        queries = jnp.matmul(queries, rotation,
                             precision=lax.Precision.HIGHEST)
    n = codes.shape[0]
    kk = min(k, n)
    if block_rows is None:
        block_rows = _SEARCH_BLOCK
        itemsize = jnp.dtype(compute_dtype).itemsize
        while (block_rows > 8192
               and block_rows * codes.shape[1] * 128 * itemsize > (3 << 30)):
            block_rows //= 2
    # any N: full blocks through lax.map + one static remainder block (the
    # old rule silently fell back to an unblocked scan — and its unbounded
    # reconstruct transient — whenever block_rows did not divide N)
    block = min(block_rows, n)

    def scan_block(c_blk, sq_blk, v_blk):
        rec = _reconstruct(c_blk, centroids, compute_dtype, coarse=coarse)
        return scan_distances(
            queries, rec, None, sq_blk, v_blk,
            metric=metric, compute_dtype=compute_dtype,
        )

    if block == n:
        negd, idx = lax.top_k(-scan_block(codes, sqnorm, valid), kk)
        return negd, idx.astype(jnp.int32)

    blocks = n // block
    rem = n % block
    kb = min(kk, block)

    def body(i):
        sl = lambda a: lax.dynamic_slice_in_dim(a, i * block, block, axis=0)
        dist = scan_block(sl(codes), sl(sqnorm), sl(valid))
        vals, idx = lax.top_k(-dist, kb)
        return vals, (idx + i * block).astype(jnp.int32)

    vals, ids = lax.map(body, jnp.arange(blocks))
    q = queries.shape[0]
    vals = jnp.moveaxis(vals, 0, 1).reshape(q, blocks * kb)
    ids = jnp.moveaxis(ids, 0, 1).reshape(q, blocks * kb)
    if rem:
        cut = blocks * block
        tdist = scan_block(codes[cut:], sqnorm[cut:], valid[cut:])
        tvals, tidx = lax.top_k(-tdist, min(kk, rem))
        vals = jnp.concatenate([vals, tvals], axis=1)
        ids = jnp.concatenate([ids, (tidx + cut).astype(jnp.int32)], axis=1)
    negd, midx = lax.top_k(vals, kk)
    return negd, jnp.take_along_axis(ids, midx, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "metric"))
def pq_rerank_neg_topk(queries, negd, ids, codes, centroids, *, k,
                       metric: Metric = Metric.COSINE, rotation=None,
                       coarse=None):
    """Re-score a shortlist against the EXACT PQ reconstruction.

    ``negd/ids [Q, C]`` come from the f8 reconstruction-cache scan (whose
    recall trails pure ADC by the f8 storage noise, ~0.08 measured at 10M);
    gathering the C code rows per query and reconstructing them in f32
    removes that noise for the price of a tiny [Q*C, M] gather. The
    ceiling remains PQ reconstruction quality — for more, raise M
    (dsub=4 doubles code size and lifted recall@10 0.60 -> 0.78 at 262k)
    or add a full-precision rerank tier outside PQ mode.
    ``queries`` are unrotated; pass the codebook rotation.
    """
    metric = Metric.parse(metric)
    safe = jnp.where(ids >= 0, ids, 0)
    crow = jnp.take(codes, safe.reshape(-1), axis=0)      # [Q*C, code_width]
    return pq_rescore_rows(queries, negd, ids, crow, centroids,
                           k=k, metric=metric, rotation=rotation,
                           coarse=coarse)


@partial(jax.jit, static_argnames=("k", "metric"))
def pq_rescore_rows(queries, negd, ids, crow, centroids, *, k,
                    metric: Metric = Metric.COSINE, rotation=None,
                    coarse=None):
    """Rescoring tail of :func:`pq_rerank_neg_topk` for callers that
    gather the ``[Q*C, code_width]`` shortlist code rows themselves —
    chiefly the host-resident-codes serving mode, where the authoritative
    codes never live on device and the (tiny) shortlist rows are gathered
    on the host and uploaded."""
    metric = Metric.parse(metric)
    from coltt_tpu.ops.topk import rescore_topk

    queries = jnp.asarray(queries, jnp.float32)
    if rotation is not None:
        # scores depend on it: full f32 (a GPU runs f32 matmuls as TF32
        # by default)
        queries = jnp.matmul(queries, rotation,
                             precision=lax.Precision.HIGHEST)
    qn, c = ids.shape
    nrows = crow.shape[0]
    m = crow.shape[1] - (_COARSE_BYTES if coarse is not None else 0)
    # block the reconstruct: its gather lane-pads dsub to 128, so an
    # unblocked [Q*C, M, 128] transient is ~4 GB at Q=512, C=40, M=384
    # (_RECON_TRANSIENT_BYTES note)
    blk = _recon_block_for(nrows, m)
    if nrows > blk:
        nb = nrows // blk
        rec = lax.map(
            lambda cb: _reconstruct(cb, centroids, jnp.float32,
                                    coarse=coarse),
            crow[: nb * blk].reshape(nb, blk, -1),
        ).reshape(nb * blk, -1)
        if nrows % blk:
            rec = jnp.concatenate(
                [rec, _reconstruct(crow[nb * blk:], centroids, jnp.float32,
                                   coarse=coarse)]
            )
    else:
        rec = _reconstruct(crow, centroids, jnp.float32, coarse=coarse)
    d = rec.shape[-1]
    return rescore_topk(queries, rec.reshape(qn, c, d), negd, ids,
                        k=k, metric=metric, compute_dtype=jnp.float32)


def pq_scan_topk(
    queries, codes, codebook: PQCodebook, sqnorm, valid, *,
    k: int, metric: Metric = Metric.COSINE, compute_dtype=jnp.bfloat16,
):
    """Top-k PQ scan with 0-100 normalized scores (scan_topk parity)."""
    from coltt_tpu.ops.score import normalize_score

    metric = Metric.parse(metric)
    negd, idx = pq_scan_neg_topk(
        queries, codes, codebook.centroids, sqnorm, valid,
        k=k, metric=metric, compute_dtype=compute_dtype,
        rotation=codebook.rotation, coarse=codebook.coarse,
    )
    score = jnp.where(jnp.isinf(negd), -jnp.inf, normalize_score(-negd, metric))
    return score, idx
