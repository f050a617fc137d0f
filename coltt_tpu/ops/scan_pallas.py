"""Pallas fused scan+top-k kernel: the high-throughput FLAT search path.

Reference parity: the replacement for the reference's hottest loop — the
full FLAT scan with per-shard bounded heaps
(``edge/f16_vectorstore.go:131-187`` VertexSearch + goroutine fan-out,
``pkg/distance/simd`` AVX kernels).

Why a kernel instead of XLA: the jnp scan (ops/topk.py) materializes the
``[Q, N]`` f32 score matrix in device memory — at Q=2048, N=1M that is
8 GB written and 8 GB read per batch, ten times the size of the int8
corpus itself. This kernel keeps each score tile in registers and reduces
it to one survivor per bin of ``BIN_ROWS`` contiguous rows, so only
``[Q, N/BIN_ROWS]`` int32 keys ever reach device memory (32x less); a
small selection pass finishes off. The survivor is a single packed int32
*monotone key*, built by **biasing the score positive before packing**: a
bias ``B`` — a rigorous Cauchy-Schwarz upper bound on |score|, static for
the int8 cosine path, a cheap traced reduction otherwise — rides in
``rowadd``, so every valid score lands in ``(0, 2B]``. For positive f32
values the raw bit pattern already orders like the value, so the key is
just ``bitcast(score + B)`` with the row's position inside its bin
replacing the low mantissa bits (an absolute perturbation below
``2^-17 * B``, far below quantization error). The bin reduction is a plain
integer ``maximum``, the kernel writes ONE output instead of a (vals, ids)
pair, and the winner's row id is reconstructed bit-wise after the final
top-k — no [Q, N/bin] id array, no gather.

The bias serves two purposes. (1) *Cheap keys*: without it, making f32
keys monotone needs the sign-fold involution (``b ^ ((b >> 31) &
0x7fffffff)``) on every [Q, N] element; with the bias folded into
``rowadd`` the packing is 2 integer ops (and, or). (2) *No denormals*:
valid scores sit at magnitude ~B and tombstones at ~-3e38, so neither the
integer keys nor the f32 view the final selection consumes can be flushed
to zero and fabricate a row id (see ops/topk.py fetch_scores_ids).

Kernel layout (one Triton program per (query block, row tile); nothing
carries between programs, so the grid is fully parallel):

- **the D loop runs inside the block**: ``lax.fori_loop`` over
  ``d_tile``-wide slices of the query and code tiles, accumulating one
  ``[qblock, rtile]`` tile. Triton software-pipelines the loads across
  ``num_stages`` shared-memory buffers and issues tensor-core products.
- **int8 codes take the s8 x s8 -> s32 tensor-core path**: queries are
  quantized to int8 on the fly and both quantization scales fold into one
  f32 FMA in the epilogue. Other storage dtypes are converted to the
  compute dtype (bf16 by default) tile by tile.
- **the bin reduction stays in registers**: the epilogue packs each score
  with its row offset inside its bin (``row % BIN_ROWS``) and reduces a
  ``[qblock, rtile/BIN_ROWS, BIN_ROWS]`` view with an integer max.
- **query blocks are the fastest grid axis**, so programs that run
  together read the same code tile (it is fetched from device memory
  about once and served from L2 to every query block).
- **per-query factors leave the kernel**: anything affine per query
  (query norm, query squared-norm, the int8 query scale) preserves ranking
  within that query, so it is applied to the ``[Q, k]`` winners after the
  final selection instead of to all ``[Q, N]`` scores. For the euclidean
  int8 path the query scale must multiply only the dot term, so there the
  whole batch shares one scalar query scale (folded into the per-row
  multiplier) rather than per-query scales.

The reduction is approximate in the same sense as XLA's ApproxTopK and
the bin-reduction recipe of arXiv:2206.14286: one survivor per bin, so two
true top-k rows colliding in one bin lose the weaker one. With rows placed
independently of their scores, the rank-r item shares its bin with one of
the r-1 better ones with probability ~(r-1)*(BIN_ROWS-1)/N: at k=10,
BIN_ROWS=32, N=1M the expected recall loss is ~45*31/N = 1.4e-4.
The final selection over the [Q, N/BIN_ROWS] survivors is plain XLA:
``lax.top_k`` ("exact"), ``lax.approx_max_k`` ("approx", "approx2"), or
the two-survivors-per-strided-slot pass (``_slot2_select``, "slot2*").
Stores keep the exact XLA path as default and expose this kernel as the
``fused`` search mode.

Kernel shape rules (:func:`supports`): cosine and (squared) euclidean,
D % 128 == 0, N % ROW_TILE == 0 (stores allocate in 8192-row quanta), any
storage dtype but f16. Queries are padded to the query block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from coltt_tpu.ops.distance import Metric, quantize_queries_i8
from coltt_tpu.ops.score import normalize_score

BIN_ROWS = 32     # contiguous rows per candidate bin (one survivor each)
ROW_TILE = 256    # largest row tile; stores and shards pad N to it
_QBLOCK = 128     # largest query block per program
_D_TILE_BYTES = 128  # bytes of each row per pipelined D step
# the accumulator tile holds at most this many [qblock, rtile] elements
# (128 x 128 int32/f32 over 4 warps = 128 registers per thread)
_ACC_ELEMS = 128 * 128
_NUM_WARPS = 4
KERNEL_NAME = "coltt_binmax_scan"  # the custom call's name in compiled HLO

# tombstoned rows get a large finite negative instead of -inf (finite
# keeps the unpack contract simple). Anything below _INVALID_CUT is
# reported as -inf after selection.
# plain Python floats, NOT jnp scalars: a module-level jnp constant
# initializes the XLA backend at import, which breaks
# jax.distributed.initialize in multi-process programs
_PENALTY = -3.0e38
_INVALID_CUT = -1.0e30


def interpret_for(platform: str) -> bool:
    """``interpret=`` for a kernel on ``platform``: compiled through
    Triton on ``gpu``, interpreted on ``cpu`` (the test backend). Any
    other platform has no lowering for this kernel and raises."""
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise NotImplementedError(
        f"the fused scan kernel has no lowering for platform {platform!r} "
        "(gpu compiles it through Triton, cpu interprets it)"
    )


def _tiles(q: int, itemsize: int) -> tuple[int, int, int, int]:
    """(qblock, rtile, d_tile, num_stages) for a batch of q queries over
    codes computed at ``itemsize`` bytes per element."""
    qblock = 16
    while qblock < min(q, _QBLOCK):
        qblock *= 2
    rtile = min(ROW_TILE, _ACC_ELEMS // qblock)
    d_tile = _D_TILE_BYTES // itemsize
    # shared memory per stage: (qblock + rtile) * d_tile * itemsize bytes
    stages = 3 if itemsize <= 2 else 2
    return qblock, rtile, d_tile, stages


def _kernel(q_ref, c_ref, rowmul_ref, rowadd_ref, out_ref, *,
            compute_dtype, d_tile):
    """One program: score a [qblock, rtile] tile, keep one packed survivor
    per bin of BIN_ROWS rows.

    ``rowmul``/``rowadd`` are per-row (corpus) factors; per-query factors
    are applied by the caller after the final top-k (see module docstring).
    ``rowadd`` carries the positivity bias, so every valid score's f32 bit
    pattern IS a monotone non-negative int32 key; the packing masks the low
    mantissa bits and ORs in the row's offset inside its bin, then an
    integer max reduces each bin. Tombstone scores (~-3e38) bitcast to
    negative int32 and lose to every valid key; their order among
    themselves is scrambled, which is fine — they all fall below
    ``_INVALID_CUT`` after unpacking.
    """
    qblock, d = q_ref.shape
    rtile = c_ref.shape[0]
    int8 = c_ref.dtype == jnp.int8
    acc_dtype = jnp.int32 if int8 else jnp.float32
    precision = (lax.Precision.HIGHEST if compute_dtype == jnp.float32
                 else None)

    def step(t, acc):
        sl = pl.ds(pl.multiple_of(t * d_tile, d_tile), d_tile)
        a = q_ref[:, sl]
        b = c_ref[:, sl]
        if not int8:
            a = a.astype(compute_dtype)
            b = b.astype(compute_dtype)
        return acc + lax.dot_general(
            a, b, dimension_numbers=(((1,), (1,)), ((), ())),
            precision=precision, preferred_element_type=acc_dtype,
        )

    acc = lax.fori_loop(0, d // d_tile, step,
                        jnp.zeros((qblock, rtile), acc_dtype))
    val = (acc.astype(jnp.float32) * rowmul_ref[...][None, :]
           + rowadd_ref[...][None, :])
    # biased-positive scores: raw f32 bits are already a monotone
    # non-negative int32 key (see module docstring) — 2 integer ops
    offset = lax.broadcasted_iota(jnp.int32, (qblock, rtile), 1) % BIN_ROWS
    keys = (lax.bitcast_convert_type(val, jnp.int32)
            & jnp.int32(-BIN_ROWS)) | offset
    out_ref[...] = jnp.max(
        keys.reshape(qblock, rtile // BIN_ROWS, BIN_ROWS), axis=2
    )


@functools.partial(
    jax.jit,
    static_argnames=("compute_dtype", "qblock", "rtile", "d_tile",
                     "num_stages"),
)
def _binmax_scan(queries, codes, rowmul, rowadd, *, compute_dtype, qblock,
                 rtile, d_tile, num_stages):
    """Grid scan -> packed per-bin max key: [qp, N / BIN_ROWS] int32.

    Column ``c`` of the output is the bin of rows
    ``[c * BIN_ROWS, (c + 1) * BIN_ROWS)``; the winning row's offset inside
    the bin is in the low mantissa bits (see module docstring).
    """
    qp, d = queries.shape
    n = codes.shape[0]
    nbins = n // BIN_ROWS
    wbins = rtile // BIN_ROWS
    return pl.pallas_call(
        functools.partial(_kernel, compute_dtype=compute_dtype,
                          d_tile=d_tile),
        out_shape=jax.ShapeDtypeStruct((qp, nbins), jnp.int32),
        # query blocks vary fastest: concurrent programs share a code tile
        grid=(qp // qblock, n // rtile),
        in_specs=[
            pl.BlockSpec((qblock, d), lambda i, j: (i, 0)),
            pl.BlockSpec((rtile, d), lambda i, j: (j, 0)),
            pl.BlockSpec((rtile,), lambda i, j: (j,)),
            pl.BlockSpec((rtile,), lambda i, j: (j,)),
        ],
        out_specs=pl.BlockSpec((qblock, wbins), lambda i, j: (i, j)),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=num_stages),
        interpret=interpret_for(jax.default_backend()),
        name=KERNEL_NAME,
        cost_estimate=pl.CostEstimate(
            flops=2 * qp * d * n,
            bytes_accessed=n * d * codes.dtype.itemsize
            + qp * d * queries.dtype.itemsize + qp * nbins * 4,
            transcendentals=0,
        ),
    )(queries, codes, rowmul, rowadd)


def _slot_plan(nb: int):
    """Pick ``(members S, width)`` for the two-survivors-per-slot selection
    (``final="slot2"``): ``width`` must divide ``nb``; multiples of 128 are
    preferred so the member slices stay aligned. Among aligned choices the
    largest S <= 48 wins (narrowest final sort); S is capped because the
    two-survivor loss grows ~(r*S/nb)^2/2 at shortlist rank r. Returns None
    when no usable split exists."""
    aligned = [s for s in range(8, 49) if nb % s == 0 and (nb // s) % 128 == 0]
    if aligned:
        s = max(aligned)
        return s, nb // s
    loose = [s for s in range(8, 49) if nb % s == 0]
    if loose:
        s = max(loose)
        return s, nb // s
    return None


def _slot2_select(keys, kk: int, low_bits: int, style: str = "mask"):
    """Two-survivors-per-strided-slot selection over packed int32 keys.

    The collision-loss repair for a one-survivor-per-slot selection stage
    (which drops true top-10 rows that int8 noise pushed to shortlist rank
    ~40, miss ~ rank/2048). Here slot ``c`` holds the S strided columns
    ``{c, c+width, ...}`` (a free row-major reshape) and keeps its best TWO
    members, so an item is lost only when two better items share its slot:
    miss ~ (r*(S-1)/nb)^2 / 2 — ~1e-3 at rank 40. The member index rides in
    spare low mantissa bits just above the kernel's bin-offset bits
    (``low_bits``), a ~2^-(23-low_bits-mbits) relative perturbation, far
    below int8 storage noise — and the rerank stage re-scores the
    shortlist anyway. The final exact ``lax.top_k`` runs over only
    ``[Q, 2*width]`` survivors, not [Q, nb].

    Returns ``(sel, pos, drop_bits)``: the selected keys, their original
    bin columns, and how many low key bits are now index payload (callers
    mask them off before un-biasing the value).
    """
    qp, nb = keys.shape
    plan = _slot_plan(nb)
    if plan is None or 2 * (nb // plan[0]) < kk:
        # no usable split / shortlist wider than the reduced set: exact
        fview = lax.bitcast_convert_type(keys, jnp.float32)
        fsel, pos = lax.top_k(fview, kk)
        return lax.bitcast_convert_type(fsel, jnp.int32), pos, low_bits
    s_members, width = plan
    mbits = (s_members - 1).bit_length()
    clear = jnp.int32(~(((1 << mbits) - 1) << low_bits))
    imin = jnp.iinfo(jnp.int32).min
    km = keys.reshape(qp, s_members, width)

    def inj(s):
        return (km[:, s] & clear) | jnp.int32(s << low_bits)

    if style in ("mask", "maska"):
        # two reduction passes, no loop-carried chain: m1 = max over
        # members, m2 = max with the winner masked out. Member tags make
        # every key distinct, so exactly one element matches m1 per slot.
        tag = (jnp.arange(s_members, dtype=jnp.int32)
               << low_bits)[None, :, None]
        tagged = (km & clear) | tag
        m1 = jnp.max(tagged, axis=1)
        m2 = jnp.max(
            jnp.where(tagged == m1[:, None, :], imin, tagged), axis=1
        )
    elif style == "tree":
        # pairwise (m1, m2) merges, log2(S) dependency depth
        parts = [(inj(s), None) for s in range(s_members)]
        while len(parts) > 1:
            nxt = []
            for i in range(0, len(parts) - 1, 2):
                (a1, a2), (b1, b2) = parts[i], parts[i + 1]
                hi = jnp.maximum(a1, b1)
                lo = jnp.minimum(a1, b1)
                if a2 is not None:
                    lo = jnp.maximum(lo, a2)
                if b2 is not None:
                    lo = jnp.maximum(lo, b2)
                nxt.append((hi, lo))
            if len(parts) % 2:
                nxt.append(parts[-1])
            parts = nxt
        m1, m2 = parts[0]
        if m2 is None:  # s_members == 1 can't happen (plan range), defensive
            m2 = jnp.full_like(m1, imin)
    else:  # "chain": the linear min/max cascade
        m1 = inj(0)
        m2 = jnp.full_like(m1, imin)
        for s in range(1, s_members):
            x = inj(s)
            lo = jnp.minimum(x, m1)
            m1 = jnp.maximum(x, m1)
            m2 = jnp.maximum(m2, lo)
    cand = jnp.concatenate([m1, m2], axis=1)              # [qp, 2*width]
    fcand = lax.bitcast_convert_type(cand, jnp.float32)
    if style.endswith("a"):
        # ApproxTopK tail: with budget >= the reduced width this is
        # lossless
        fsel, cpos = lax.approx_max_k(fcand, kk, recall_target=0.95)
    else:
        fsel, cpos = lax.top_k(fcand, kk)
    sel = lax.bitcast_convert_type(fsel, jnp.int32)
    member = (sel >> low_bits) & ((1 << mbits) - 1)
    pos = member * width + cpos % width                   # original bin column
    return sel, pos, low_bits + mbits


def supports(n: int, dim: int, metric, dtype) -> bool:
    """Whether the fused kernel handles this store shape."""
    metric = Metric.parse(metric)
    return (
        metric in (Metric.COSINE, Metric.EUCLIDEAN)
        and dim % 128 == 0
        and n % ROW_TILE == 0
        and dtype != jnp.float16  # f16 codes keep the XLA path
    )


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "compute_dtype", "final"),
)
def fused_scan_neg_topk(
    queries,
    codes,
    scale,
    sqnorm,
    valid,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=jnp.bfloat16,
    final: str = "auto",
):
    """Fused approximate top-k: ``(negdist [Q,k], ids [Q,k])``.

    Drop-in for :func:`coltt_tpu.ops.topk.scan_neg_topk` where
    :func:`supports` holds. Ranking values are transformed back to the
    same negated-distance convention so multi-device merges compose.
    int8 codes run on the int8 tensor-core path (queries quantized on the
    fly). ``final``: selection over the [Q, N/BIN_ROWS] bin survivors —
    "exact" (lax.top_k), "approx" (ApproxTopK), "approx2", "slot2*" (see
    :func:`_slot2_select`), or "auto" (approx for big stores, exact for
    small ones).
    """
    metric = Metric.parse(metric)
    queries = jnp.asarray(queries, jnp.float32)
    q, d = queries.shape
    n = codes.shape[0]
    int8 = codes.dtype == jnp.int8

    itemsize = 1 if int8 else jnp.dtype(compute_dtype).itemsize
    qblock, rtile, d_tile, stages = _tiles(q, itemsize)
    qp = -(-q // qblock) * qblock
    if qp != q:
        queries = jnp.pad(queries, [(0, qp - q), (0, 0)])

    scale_row = (jnp.ones((n,), jnp.float32) if scale is None
                 else scale.reshape(n))
    penalty = jnp.where(valid, 0.0, _PENALTY) if valid is not None else (
        jnp.zeros((n,), jnp.float32))

    if int8:
        # cosine: per-query symmetric int8; qscale is per-query -> applied
        # after the selection. Euclidean: the scale multiplies only the dot
        # term, not -|v|^2, so it cannot leave the kernel per query — the
        # batch shares one scalar scale.
        if metric == Metric.COSINE:
            qkern, qscale = quantize_queries_i8(queries)
        else:
            qkern, gscale = quantize_queries_i8(queries, per_query=False)
    else:
        qkern = queries

    if metric == Metric.COSINE:
        rowmul = scale_row * jax.lax.rsqrt(jnp.maximum(sqnorm, 1e-30))
        rowadd = penalty
        qn = jnp.maximum(
            jnp.sqrt(jnp.sum(queries * queries, axis=1, keepdims=True)), 1e-30
        )
        qmul = (qscale / qn) if int8 else (1.0 / qn)   # [qp, 1]
        qadd = jnp.float32(-1.0)  # val*qmul = cos_sim -> -dist = cos_sim - 1
        # |val| = |dot| * scale/||deq_row|| <= ||q_kern|| by Cauchy-Schwarz
        # (||codes_row|| = ||deq_row||/scale): static 127*sqrt(d) for int8
        # queries, else the traced max query norm
        if int8:
            bound = 127.0 * float(np.sqrt(d))
        else:
            bound = jnp.sqrt(jnp.max(jnp.sum(queries * queries, axis=1)))
    else:  # EUCLIDEAN (squared): val = 2*dot*scale - |v|^2 (+penalty)
        rowmul = 2.0 * scale_row * (gscale if int8 else 1.0)
        rowadd = penalty - sqnorm
        qmul = jnp.ones((qp, 1), jnp.float32)
        qadd = -jnp.sum(queries * queries, axis=1, keepdims=True)  # -> -dist
        # |2*dot*scale_eff| <= 2*||q_kern||*||deq_row|| (Cauchy-Schwarz,
        # same norm identity as above), plus the -|v|^2 term
        maxsq = jnp.max(sqnorm)
        qn_bound = (127.0 * float(np.sqrt(d)) * gscale if int8
                    else jnp.sqrt(jnp.max(jnp.sum(queries * queries, axis=1))))
        bound = 2.0 * qn_bound * jnp.sqrt(maxsq) + maxsq
    # 2x margin covers bf16 input rounding (<1% each side) and the f32
    # FMA rounding of val itself; the clamp keeps penalty + bias finite
    bias = jnp.minimum(jnp.float32(2.0) * bound, jnp.float32(1e36))
    rowadd = rowadd + bias

    keys = _binmax_scan(
        qkern, codes, rowmul.astype(jnp.float32), rowadd.astype(jnp.float32),
        compute_dtype=compute_dtype, qblock=qblock, rtile=rtile,
        d_tile=d_tile, num_stages=stages,
    )
    kk = min(k, keys.shape[1])
    nb = keys.shape[1]
    sbits = BIN_ROWS.bit_length() - 1
    if final == "auto":
        final = "exact" if nb <= 8192 else "approx"
    # Select on the f32 VIEW of the keys in every mode: thanks to the
    # bias, valid keys are bit patterns of normal positive floats (order
    # preserved, all 32 bits, nothing flushable) and tombstones are ~-3e38
    # normals that sort last. The returned values bitcast straight back to
    # keys, so no gather of the key matrix. On GPU and CPU, XLA lowers
    # approx_max_k to an exact top-k, so "approx" and "exact" select the
    # same rows there.
    fview = lax.bitcast_convert_type(keys, jnp.float32)
    drop = sbits
    if (final in ("slot2", "slot2t", "slot2c", "slot2a")
            and kk < nb and _slot_plan(nb)):
        style = {"slot2": "mask", "slot2t": "tree", "slot2c": "chain",
                 "slot2a": "maska"}[final]
        sel, pos, drop = _slot2_select(keys, kk, sbits, style)
    elif final == "approx2" and kk < nb and nb >= 16384 and nb % 2 == 0:
        sub = nb // 2
        fv = fview.reshape(qp * 2, sub)
        fs, ps = lax.approx_max_k(fv, kk, recall_target=0.95)
        # row r of fv is (query r // 2, half r % 2): shift the in-half
        # positions back to global bin indices
        ps = ps + (
            (jnp.arange(qp * 2, dtype=jnp.int32) % 2) * sub
        )[:, None]
        fsel, i2 = lax.top_k(fs.reshape(qp, 2 * kk), kk)
        pos = jnp.take_along_axis(ps.reshape(qp, 2 * kk), i2, axis=1)
        sel = lax.bitcast_convert_type(fsel, jnp.int32)
    elif final == "approx" and kk < nb:
        fsel, pos = lax.approx_max_k(fview, kk, recall_target=0.95)
        sel = lax.bitcast_convert_type(fsel, jnp.int32)
    else:
        fsel, pos = lax.top_k(fview, kk)  # [qp, kk] over N/bin candidates
        sel = lax.bitcast_convert_type(fsel, jnp.int32)
    # unpack: the column is the bin, the low key bits the row inside it
    ids = pos * BIN_ROWS + (sel & (BIN_ROWS - 1))
    best = lax.bitcast_convert_type(
        sel & jnp.int32(-(1 << drop)), jnp.float32
    )

    # per-query affine back to the negated-distance convention (qmul > 0,
    # so ranking within each query is unchanged; merges stay compatible).
    # un-bias first: best ~ B + val, and the packing error (< 2^-17 * B) —
    # not this subtraction — dominates the residual.
    negd = (best - bias) * qmul + qadd
    negd = jnp.where(best > _INVALID_CUT, negd, -jnp.inf)
    return negd[:q], ids[:q].astype(jnp.int32)


def fused_scan_topk(
    queries, codes, scale, sqnorm, valid, *, k,
    metric: Metric = Metric.COSINE, compute_dtype=jnp.bfloat16,
    final: str = "auto",
):
    """0-100-scored variant (scan_topk parity)."""
    metric = Metric.parse(metric)
    negd, idx = fused_scan_neg_topk(
        queries, codes, scale, sqnorm, valid, k=k, metric=metric,
        compute_dtype=compute_dtype, final=final,
    )
    score = jnp.where(jnp.isinf(negd), -jnp.inf, normalize_score(-negd, metric))
    return score, idx
