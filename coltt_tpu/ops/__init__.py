"""Math / primitive layer.

Accelerator-native counterpart of the reference's L1 primitive layer
(``pkg/distance`` SIMD kernels, ``pkg/compresshelper`` f16/bf16/f8 codecs,
``pkg/distancepq`` PQ distance registry — see SURVEY.md §2.5). Instead of
per-pair SIMD calls, everything here is batched: distances are
``[Q, D] x [N, D] -> [Q, N]`` matrix products, quantization is dtype-level
(XLA-fusable) with per-row scales.
"""

from coltt_tpu.ops.quant import (
    Quantization,
    storage_dtype,
    quantize,
    dequantize,
)
from coltt_tpu.ops.distance import Metric, pairwise_distance, distance_pair
from coltt_tpu.ops.score import normalize_score, denormalize_score

__all__ = [
    "Quantization",
    "storage_dtype",
    "quantize",
    "dequantize",
    "Metric",
    "pairwise_distance",
    "distance_pair",
    "normalize_score",
    "denormalize_score",
]
