"""Inverted index, filter language, and schema analyzer tests.

Covers the reference's filter semantics (pkg/inverted: EQ/NEQ/range/AND/OR),
the legacy string-normalized core variant (pkg/index), serialization
roundtrips, and the standardAnalyzer/dropKeyAnalyzer contracts.
"""

import numpy as np
import pytest

from coltt_tpu.index.bitmap import Bitset, InvertedIndex
from coltt_tpu.index.filter import And, CompositeFilter, Filter, LogicalOp, Op, Or, filter_from_dict
from coltt_tpu.index.schema import (
    CollectionSchema,
    FieldSchema,
    FieldType,
    SchemaError,
)


# -- Bitset ---------------------------------------------------------------

def test_bitset_basic():
    b = Bitset()
    for i in (0, 5, 63, 64, 1000):
        b.set(i)
    assert b.count() == 5
    assert b.test(64) and not b.test(65)
    b.clear(64)
    assert not b.test(64)
    np.testing.assert_array_equal(b.ids(), [0, 5, 63, 1000])


def test_bitset_algebra():
    a = Bitset.from_ids([1, 2, 3, 100])
    b = Bitset.from_ids([2, 3, 4])
    np.testing.assert_array_equal((a & b).ids(), [2, 3])
    np.testing.assert_array_equal((a | b).ids(), [1, 2, 3, 4, 100])
    np.testing.assert_array_equal(a.andnot(b).ids(), [1, 100])


def test_bitset_roundtrip():
    a = Bitset.from_ids([7, 900, 12345])
    back = Bitset.from_bytes(a.to_bytes())
    np.testing.assert_array_equal(back.ids(), a.ids())


def test_bitset_unique_keys_stay_small():
    """One bitset per primary key: each holds one far-out slot in a word
    or two, not a dense prefix (a 1M-row index would need ~60 GB)."""
    bs = [Bitset() for _ in range(3)]
    for b, slot in zip(bs, (5, 700_000, 999_999)):
        b.set(slot)
        assert len(b.words) == 1 and b.test(slot) and b.count() == 1
        np.testing.assert_array_equal(b.ids(), [slot])
        assert len(b.to_bytes()) <= 17
        back = Bitset.from_bytes(b.to_bytes())
        np.testing.assert_array_equal(back.ids(), [slot])
    merged = bs[1] | bs[0]
    np.testing.assert_array_equal(merged.ids(), [5, 700_000])
    assert not (bs[1] & bs[2]).any()
    np.testing.assert_array_equal(
        Bitset.from_ids(range(1000)).andnot(bs[0]).ids()[:6], [0, 1, 2, 3, 4, 6])


def test_bitset_window_grows_both_ways():
    b = Bitset()
    for i in (6400, 64, 130_000, 1):
        b.set(i)
    np.testing.assert_array_equal(b.ids(), [1, 64, 6400, 130_000])
    b.clear(64)
    assert not b.test(64) and b.test(6400) and not b.test(10**9)
    m = b.mask(7000)
    assert m[1] and m[6400] and m.sum() == 2


def test_bitset_reads_flat_form():
    """Snapshots written before the window form hold raw words from word 0
    (length a multiple of 8): they still load."""
    words = np.zeros(4, np.uint64)
    words[3] = 1 << 5
    np.testing.assert_array_equal(
        Bitset.from_bytes(words.tobytes()).ids(), [3 * 64 + 5])


def test_bitset_mask():
    a = Bitset.from_ids([0, 3])
    m = a.mask(5)
    np.testing.assert_array_equal(m, [True, False, False, True, False])


# -- InvertedIndex --------------------------------------------------------

@pytest.fixture
def idx():
    ix = InvertedIndex()
    rows = [
        {"city": "seoul", "stars": 5, "price": 10.5, "open": True},
        {"city": "seoul", "stars": 3, "price": 20.0, "open": False},
        {"city": "tokyo", "stars": 5, "price": 30.0, "open": True},
        {"city": "osaka", "stars": 1, "price": 5.0, "open": False},
    ]
    for slot, md in enumerate(rows):
        ix.add(slot, md)
    return ix


def test_eq_neq(idx):
    np.testing.assert_array_equal(idx.search(Filter("city", Op.EQ, "seoul")).ids(), [0, 1])
    np.testing.assert_array_equal(idx.search(Filter("city", Op.NEQ, "seoul")).ids(), [2, 3])
    assert idx.search(Filter("city", Op.EQ, "busan")).count() == 0


def test_range_ops(idx):
    np.testing.assert_array_equal(idx.search(Filter("stars", Op.GTE, 3)).ids(), [0, 1, 2])
    np.testing.assert_array_equal(idx.search(Filter("stars", Op.GT, 3)).ids(), [0, 2])
    np.testing.assert_array_equal(idx.search(Filter("price", Op.LT, 15.0)).ids(), [0, 3])
    np.testing.assert_array_equal(idx.search(Filter("price", Op.LTE, 20.0)).ids(), [0, 1, 3])


def test_bool_values(idx):
    np.testing.assert_array_equal(idx.search(Filter("open", Op.EQ, True)).ids(), [0, 2])


def test_composite(idx):
    expr = And(Filter("city", Op.EQ, "seoul"), Filter("stars", Op.GTE, 4))
    np.testing.assert_array_equal(idx.search(expr).ids(), [0])
    expr = Or(Filter("city", Op.EQ, "osaka"), Filter("stars", Op.EQ, 5))
    np.testing.assert_array_equal(idx.search(expr).ids(), [0, 2, 3])
    nested = And(
        Or(Filter("city", Op.EQ, "seoul"), Filter("city", Op.EQ, "tokyo")),
        Filter("open", Op.EQ, True),
    )
    np.testing.assert_array_equal(idx.search(nested).ids(), [0, 2])


def test_remove(idx):
    idx.remove(0, {"city": "seoul", "stars": 5, "price": 10.5, "open": True})
    np.testing.assert_array_equal(idx.search(Filter("city", Op.EQ, "seoul")).ids(), [1])
    assert not idx.live.test(0)


def test_index_roundtrip(idx):
    back = InvertedIndex.from_bytes(idx.to_bytes())
    for expr in [
        Filter("city", Op.EQ, "seoul"),
        Filter("stars", Op.GTE, 3),
        Filter("open", Op.EQ, True),
    ]:
        np.testing.assert_array_equal(back.search(expr).ids(), idx.search(expr).ids())


def test_string_normalized_core_variant():
    ix = InvertedIndex(string_normalize=True)
    ix.add(0, {"tag": 5})
    ix.add(1, {"tag": "5"})
    ix.add(2, {"tag": True})
    hits = ix.pure_search({"tag": 5})
    np.testing.assert_array_equal(hits.ids(), [0, 1])
    np.testing.assert_array_equal(ix.pure_search({"tag": "true"}).ids(), [2])
    got = ix.search_with_candidates([1, 2], {"tag": "5"})
    np.testing.assert_array_equal(got.ids(), [1])


def test_filter_serialization_roundtrip():
    expr = And(
        Filter("a", Op.GTE, 3),
        Or(Filter("b", Op.EQ, "x"), Filter("c", Op.NEQ, True)),
    )
    back = filter_from_dict(expr.to_dict())
    assert isinstance(back, CompositeFilter)
    assert back.op == LogicalOp.AND
    assert back.expressions[0] == Filter("a", Op.GTE, 3)


# -- Schema ---------------------------------------------------------------

def _schema():
    return CollectionSchema(
        name="c",
        dim=8,
        fields=[
            FieldSchema("pk", FieldType.STRING, primary_key=True),
            FieldSchema("stars", FieldType.INTEGER, enable_null=True),
            FieldSchema("note", FieldType.STRING, enable_null=True),
            FieldSchema("price", FieldType.FLOAT),
        ],
    )


def test_analyze_insert_ok():
    md = _schema().analyze_insert({"pk": "a", "stars": 4, "price": 3})
    assert md == {"pk": "a", "stars": 4, "note": "", "price": 3.0}


def test_analyze_insert_null_default():
    md = _schema().analyze_insert({"pk": "a", "price": 1.0})
    assert md["stars"] == 0 and md["note"] == ""


def test_analyze_insert_errors():
    s = _schema()
    with pytest.raises(SchemaError):
        s.analyze_insert({"stars": 4, "price": 1.0})  # missing pk
    with pytest.raises(SchemaError):
        s.analyze_insert({"pk": "a"})  # missing required price
    with pytest.raises(SchemaError):
        s.analyze_insert({"pk": "a", "price": "x"})  # type mismatch
    with pytest.raises(SchemaError):
        s.analyze_insert({"pk": "a", "price": 1.0, "bogus": 1})  # unknown field
    with pytest.raises(SchemaError):
        s.analyze_insert({"pk": "a", "price": True})  # bool is not float


def test_primary_key_must_be_string():
    with pytest.raises(SchemaError):
        CollectionSchema(
            name="bad", dim=4,
            fields=[FieldSchema("pk", FieldType.INTEGER, primary_key=True)],
        )


def test_drop_key_analyzer():
    s = _schema()
    assert s.analyze_drop_key({"pk": "z"}) == "z"
    with pytest.raises(SchemaError):
        s.analyze_drop_key({})
    with pytest.raises(SchemaError):
        s.analyze_drop_key({"pk": 3})


def test_schema_roundtrip():
    s = _schema()
    back = CollectionSchema.from_dict(s.to_dict())
    assert back == s
