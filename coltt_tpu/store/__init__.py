"""Index/store layer.

Accelerator-native counterpart of the reference's L2 index layer: the four
quantized FLAT vector spaces (``edge/*_vectorstore.go``), the CFLAT
multi-vector space (``experimental/multi_vector_vertex.go``), and the HNSW
graph (``core/vectorindex/hnsw.go``). Mutable goroutine-sharded maps become
slot-allocated dense device arrays with tombstone masks; every search is a
batched kernel (SURVEY.md §7 design stance).
"""

from coltt_tpu.store.flat import FlatStore
from coltt_tpu.store.multivec import MultiVectorStore
from coltt_tpu.store.hnsw import HnswConfig, HnswIndex

__all__ = ["FlatStore", "MultiVectorStore", "HnswConfig", "HnswIndex"]
