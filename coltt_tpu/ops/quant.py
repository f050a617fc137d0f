"""Storage quantization codecs (none / f16 / bf16 / f8).

Reference parity: ``pkg/compresshelper`` (f16: float16.go, bf16: bf16.go,
f8: float8.go) and the edge quantizer interface
``edge/quantization.go:27-37`` with impls ``edge/{f16,f8,bf16}_quantization.go``.
The reference converts scalar-by-scalar in Go and computes distances on
dequantized fp32 buffers ("storage-only compression, arithmetic in fp32",
SURVEY.md §2.3).

Design: quantization is a *dtype*, not a codec loop.

- f16  -> ``jnp.float16``   (IEEE binary16, bit-identical semantics)
- bf16 -> ``jnp.bfloat16``  (truncated f32, the tensor cores' 16-bit float type)
- f8   -> ``jnp.float8_e4m3fn`` (1-4-3 minifloat — same sign/exp/mantissa
  split the reference documents for its Float8) **plus a per-row fp32
  scale**: each vector is scaled so its absmax lands near the top of the
  e4m3 range before casting. That keeps every component in the normal
  range of the format, so the fidelity contract (cosine score delta <= 1.0
  on the 0-100 scale, ``pkg/compresshelper/compresshelper_test.go:57-59``)
  holds with margin at every dim the reference tests (128..3072).

Dequantize is ``codes.astype(f32) * scale`` — one fused multiply XLA folds
into the consuming matmul, so "arithmetic in fp32" is preserved exactly like
the reference, minus the per-pair codec calls.

The PQ / BQ enum values exist in the reference proto
(``idl/proto/v3/core.proto`` Quantization) but were never shipped; here PQ
is implemented in :mod:`coltt_tpu.ops.pq`.
"""

from __future__ import annotations

import enum

import jax.numpy as jnp


class Quantization(enum.IntEnum):
    """Matches the proto enum numbering (idl/proto/v4/edge.proto Quantization,
    idl/proto/v3/core.proto Quantization)."""

    NONE = 0
    F16 = 1
    F8 = 2
    BF16 = 3
    PQ = 4
    BQ = 5  # reserved-but-unimplemented in the reference proto; HERE it is
            # a full mode: 1-bit sign codes + Hamming shortlist + rerank
            # (ops/bq.py, FlatStore Quantization.BQ)
    I8 = 6  # beyond the reference: symmetric per-row int8 — rides the
            # int8 tensor-core rate, recall ~= f8

    @classmethod
    def parse(cls, v) -> "Quantization":
        if isinstance(v, Quantization):
            return v
        if isinstance(v, str):
            key = v.strip().upper()
            aliases = {"": "NONE", "FP16": "F16", "FP8": "F8", "BFLOAT16": "BF16",
                       "INT8": "I8"}
            key = aliases.get(key, key)
            return cls[key]
        return cls(int(v))


# Largest finite magnitude of float8_e4m3fn is 448; scale rows to absmax=240
# (a power-of-two-friendly headroom target) so rounding never saturates.
_F8_TARGET = 240.0

_STORAGE_DTYPES = {
    Quantization.NONE: jnp.float32,
    Quantization.F16: jnp.float16,
    Quantization.BF16: jnp.bfloat16,
    Quantization.F8: jnp.float8_e4m3fn,
    Quantization.I8: jnp.int8,
}


def storage_dtype(q: Quantization):
    """dtype used for the stored codes of a quantization scheme."""
    q = Quantization.parse(q)
    if q not in _STORAGE_DTYPES:
        raise ValueError(f"quantization {q!r} has no dense storage dtype")
    return _STORAGE_DTYPES[q]


def bytes_per_component(q: Quantization) -> int:
    return jnp.dtype(storage_dtype(q)).itemsize


def quantize(x, q: Quantization):
    """Quantize ``x: [..., D] float32`` -> ``(codes, scale)``.

    ``codes`` has :func:`storage_dtype`; ``scale`` is ``[..., 1] float32``
    such that ``dequantize(codes, scale) ~= x``. For none/f16/bf16 the scale
    is all-ones (kept so store state has a uniform shape); for f8 it is the
    per-row absmax scale described in the module docstring.
    """
    q = Quantization.parse(q)
    x = jnp.asarray(x, jnp.float32)
    ones = jnp.ones(x.shape[:-1] + (1,), jnp.float32)
    if q == Quantization.NONE:
        return x, ones
    if q in (Quantization.F16, Quantization.BF16):
        return x.astype(_STORAGE_DTYPES[q]), ones
    if q == Quantization.F8:
        absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
        scale = jnp.where(absmax > 0, absmax / _F8_TARGET, 1.0)
        codes = (x / scale).astype(jnp.float8_e4m3fn)
        return codes, scale
    if q == Quantization.I8:
        absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
        scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
        codes = jnp.round(x / scale).clip(-127, 127).astype(jnp.int8)
        return codes, scale
    raise ValueError(f"quantization {q!r} is not a dense codec (use ops.pq for PQ)")


def dequantize(codes, scale=None):
    """Inverse of :func:`quantize`; returns float32."""
    out = codes.astype(jnp.float32)
    if scale is not None:
        out = out * scale
    return out
