"""coltt: an accelerator-native vector-search framework in JAX.

A from-scratch re-design of the capabilities of the reference system
sjy-dv/coltt (a Go vector database; see SURVEY.md) for accelerators (it
runs on NVIDIA GPUs; the README says where it comes from):

- vectors live as dense, quantized device arrays sharded over a
  ``jax.sharding.Mesh`` instead of pointer-graphs in goroutine-sharded maps,
- FLAT / filtered / hybrid / multi-vector search are batched tensor-core
  matrix products + streaming top-k instead of per-pair SIMD distance
  calls,
- HNSW becomes fixed-shape adjacency arrays traversed by a vectorized,
  batched beam search under ``lax.while_loop``,
- the 16-way goroutine shard scan becomes a sharded axis with collective
  top-k merges over the device interconnect (and the network across
  hosts),
- persistence keeps the reference's shapes: a segmented WAL + bitcask-style
  KV for the core commit log, and a 3-object checkpoint per collection for
  edge/experimental (metadata JSON + vectors + inverted index).

Reference parity map lives in each module's docstring (file:line cites into
/root/reference).
"""

from coltt_tpu.version import __version__

from coltt_tpu.ops.quant import Quantization
from coltt_tpu.ops.distance import Metric
from coltt_tpu.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu.index.filter import Filter, CompositeFilter, Op, LogicalOp

__all__ = [
    "__version__",
    "Quantization",
    "Metric",
    "CollectionSchema",
    "FieldSchema",
    "FieldType",
    "Filter",
    "CompositeFilter",
    "Op",
    "LogicalOp",
]
