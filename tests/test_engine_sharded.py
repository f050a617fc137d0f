"""Engine-level multi-device serving (VERDICT r4 #1).

The reference's shard-parallel scan lives inside the engine its gRPC layer
serves (edge/f16_vectorstore.go:138-170 — goroutine-per-shard + merge
behind VertexSearch). These tests prove the device-mesh equivalent does too: an
EdgeEngine built with a device mesh serves create -> index -> search with
row-sharded FlatStores and shard_map collective scans, and its results
match the single-device engine on the same data.

Runs on the 8-virtual-CPU-device mesh (conftest.py).
"""

import numpy as np
import pytest

from coltt_tpu.engine.edge import EdgeEngine
from coltt_tpu.index.schema import CollectionSchema
from coltt_tpu.parallel.mesh import make_mesh
from coltt_tpu.storage.objectstore import LocalObjectStore


def _schema(name, dim=32, quantization="none", metric="cosine"):
    return CollectionSchema.from_dict({
        "name": name,
        "dim": dim,
        "metric": metric,
        "quantization": quantization,
        "fields": [
            {"name": "pk", "type": "string", "primary_key": True},
            {"name": "tag", "type": "string"},
        ],
    })


def _mk_engine(tmp_path, sub, mesh=None):
    return EdgeEngine(
        LocalObjectStore(str(tmp_path / sub)), batch_max=0, mesh=mesh
    )


def _ingest(engine, name, vecs, tags):
    mds = [{"pk": f"p{i}", "tag": tags[i]} for i in range(len(vecs))]
    engine.index_many(name, mds, vecs)


@pytest.fixture
def corpus(rng):
    n, dim = 3000, 32
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    tags = [("a" if i % 3 == 0 else "b") for i in range(n)]
    queries = rng.standard_normal((8, dim)).astype(np.float32)
    return vecs, tags, queries


def _batch_results(engine, name, queries, **kw):
    counts, scores, pks, _ = engine.search_batch(name, queries, **kw)
    out, i = [], 0
    for c in counts:
        out.append(list(zip(pks[i:i + c], np.round(scores[i:i + c], 4))))
        i += c
    return out


def test_edge_engine_sharded_flat_equivalence(tmp_path, corpus):
    """f32 FLAT: sharded engine results == single-device engine results
    (exact scan, deterministic)."""
    vecs, tags, queries = corpus
    mesh = make_mesh(8)
    e1 = _mk_engine(tmp_path, "single")
    e8 = _mk_engine(tmp_path, "mesh", mesh=mesh)
    for e in (e1, e8):
        e.create_collection(_schema("col"))
        _ingest(e, "col", vecs, tags)
    r1 = _batch_results(e1, "col", queries, limit=10)
    r8 = _batch_results(e8, "col", queries, limit=10)
    assert r1 == r8
    # the sharded store really is sharded over the mesh
    store = e8._collections["col"].store
    assert store.mesh is mesh
    assert len(store.codes.sharding.device_set) == 8


def test_edge_engine_sharded_filtered(tmp_path, corpus):
    """Filtered search on a sharded engine takes the masked-scan regime and
    matches single-device filtered results."""
    vecs, tags, queries = corpus
    expr = {"filter": {"index_name": "tag", "op": "eq", "value": "a"}}
    e1 = _mk_engine(tmp_path, "single")
    e8 = _mk_engine(tmp_path, "mesh", mesh=make_mesh(8))
    for e in (e1, e8):
        e.create_collection(_schema("col"))
        _ingest(e, "col", vecs, tags)
    r1 = _batch_results(e1, "col", queries, limit=10, filter_expression=expr)
    r8 = _batch_results(e8, "col", queries, limit=10, filter_expression=expr)
    assert r1 == r8
    for row in r8:
        assert all(int(pk[1:]) % 3 == 0 for pk, _ in row)


def test_edge_engine_sharded_mutation(tmp_path, corpus):
    """upsert/delete after initial ingest work on the sharded store (the
    scatter path over sharded arrays) and searches see the change."""
    vecs, tags, _ = corpus
    e8 = _mk_engine(tmp_path, "mesh", mesh=make_mesh(8))
    e8.create_collection(_schema("col"))
    _ingest(e8, "col", vecs, tags)
    # insert a brand-new point and search for exactly it
    probe = np.full(32, 0.5, np.float32)
    e8.index("col", {"pk": "new", "tag": "z"}, probe)
    hits = e8.search("col", probe, limit=1)
    assert hits[0].id == "new"
    # delete it; the same search must not return it
    e8.index("col", {"pk": "new"}, delete=True)
    hits = e8.search("col", probe, limit=1)
    assert hits and hits[0].id != "new"


def test_edge_engine_sharded_bq(tmp_path, rng):
    """BQ collection on a mesh: Hamming scan + shard-local rerank + merge
    equals the single-device result. N is sized so BOTH shortlist regimes
    (global k*oversample vs per-shard k*oversample) cover the whole
    corpus — otherwise the sharded result is legitimately BETTER (its
    per-shard shortlists rerank more rows), not equal."""
    n, dim = 512, 64  # k*oversample = 10*64 = 640 >= n
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    tags = ["a"] * n
    queries = rng.standard_normal((4, dim)).astype(np.float32)
    e1 = _mk_engine(tmp_path, "single")
    e8 = _mk_engine(tmp_path, "mesh", mesh=make_mesh(8))
    for e in (e1, e8):
        e.create_collection(_schema("col", dim=dim, quantization="bq"))
        _ingest(e, "col", vecs, tags)
    r1 = _batch_results(e1, "col", queries, limit=10)
    r8 = _batch_results(e8, "col", queries, limit=10)
    assert r1 == r8


def test_edge_engine_sharded_pq(tmp_path, rng):
    """PQ-cache collection on a mesh: f8-cache scan + shard-local exact-PQ
    rerank + merge. PQ training/encoding is deterministic on the same
    ingest, so sharded results must agree with single-device results to
    high overlap (tie reordering across shard-local reranks allowed)."""
    n, dim = 4096, 64
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    tags = ["a"] * n
    queries = rng.standard_normal((4, dim)).astype(np.float32)
    e1 = _mk_engine(tmp_path, "single")
    e8 = _mk_engine(tmp_path, "mesh", mesh=make_mesh(8))
    for e in (e1, e8):
        e.create_collection(_schema("col", dim=dim, quantization="pq"))
        _ingest(e, "col", vecs, tags)
    r1 = _batch_results(e1, "col", queries, limit=10)
    r8 = _batch_results(e8, "col", queries, limit=10)
    overlap = np.mean([
        len({p for p, _ in a} & {p for p, _ in b}) / max(len(a), 1)
        for a, b in zip(r1, r8)
    ])
    assert overlap >= 0.9, overlap


def test_experimental_engine_sharded_cflat(tmp_path, rng):
    """CFLAT multi-vector serving over a mesh: the experimental engine's
    MultiVectorStore shards per-field rows and scans through
    sharded_cflat_topk; results match the single-device engine (f32
    compute, exact scans)."""
    from coltt_tpu.engine.experimental import ExperimentalEngine
    from coltt_tpu.index.schema import (
        CollectionSchema, FieldSchema, FieldType,
    )

    dim, n = 16, 512
    schema = lambda: CollectionSchema(
        name="mv", dim=dim,
        fields=[FieldSchema("a_vec", FieldType.VECTOR),
                FieldSchema("b_vec", FieldType.VECTOR)],
    )
    a = rng.standard_normal((n, dim)).astype(np.float32)
    b = rng.standard_normal((n, dim)).astype(np.float32)
    mesh = make_mesh(8)
    e1 = ExperimentalEngine(LocalObjectStore(str(tmp_path / "s1")))
    e8 = ExperimentalEngine(LocalObjectStore(str(tmp_path / "s8")),
                            mesh=mesh)
    for e in (e1, e8):
        e.create_collection(schema())
        for i in range(n):
            e.index("mv", f"r{i}",
                    vectors={"a_vec": a[i], "b_vec": b[i]})
    q = [("a_vec", a[37], True, 60.0), ("b_vec", b[37], True, 40.0)]
    h1 = e1.vector_search("mv", q, top_k=5)
    h8 = e8.vector_search("mv", q, top_k=5)
    assert [h.id for h in h8] == [h.id for h in h1]
    assert h8[0].id == "r37"
    np.testing.assert_allclose([h.score for h in h8],
                               [h.score for h in h1], atol=1e-3)
    store = e8._collections["mv"].store
    assert store.mesh is mesh
    assert len(store.codes["a_vec"].sharding.device_set) == 8


def test_edge_engine_sharded_flush_load_roundtrip(tmp_path, corpus):
    """release -> load keeps the mesh: the rehydrated store is sharded and
    serves the same results."""
    vecs, tags, queries = corpus
    mesh = make_mesh(8)
    e8 = _mk_engine(tmp_path, "mesh", mesh=mesh)
    e8.create_collection(_schema("col"))
    _ingest(e8, "col", vecs, tags)
    before = _batch_results(e8, "col", queries, limit=10)
    e8.release_collection("col")
    e8.load_collection("col")
    store = e8._collections["col"].store
    assert store.mesh is mesh
    assert len(store.codes.sharding.device_set) == 8
    after = _batch_results(e8, "col", queries, limit=10)
    assert before == after
