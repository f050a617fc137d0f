"""Bitmap inverted index over metadata fields.

Reference parity: ``pkg/inverted/bitmap_index.go:28-43`` (roaring64 bitmaps
per (index, value) with EQ direct lookup, range ops scanning distinct values
with typed comparison — ``search.go:26-48``, ``satisfiesOp``
``bitmap_index.go:358``), composite AND/OR via bitmap And/Or recursion
(``search.go:50-87``), binary serialization (``save.go:131-229``); and the
legacy string-normalized variant used by core (``pkg/index/bitmap_index.go``
forcedStringTypeChanger:48, PureSearch ``search.go:48``,
SearchWitCandidates ``search.go:23``).

Design: ids here are dense *slot* indices into the store's row axis (not
sparse u64 ids — the slot allocator already densifies), so flat word-array
bitsets beat roaring: every AND/OR/NOT is a contiguous SIMD ``np.bitwise_*``
over uint64 words, and the result converts straight into the gather-index /
mask arrays the device scans consume. Popcount is ``np.bitwise_count``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from coltt_tpu.index.filter import (
    CompositeFilter,
    Filter,
    FilterExpression,
    LogicalOp,
    Op,
)
from coltt_tpu.utils import msgcodec

_WORD_BITS = 64


# windowed serialized form: this tag, the base word index (u64 LE), then
# the words. Its length is 1 mod 8, the flat form's 0 mod 8.
_WINDOW_TAG = b"\x01"


class Bitset:
    """Growable bitset over dense slot ids: a window of uint64 words that
    starts at word ``base``. A set of nearby ids (a primary key's single
    slot) takes a word or two wherever it sits, so an index over a unique
    field stays linear in the number of rows."""

    __slots__ = ("words", "base")

    def __init__(self, words: Optional[np.ndarray] = None, base: int = 0):
        self.words = (
            np.zeros(1, np.uint64) if words is None else np.asarray(words, np.uint64)
        )
        self.base = int(base)

    # -- capacity ----------------------------------------------------------
    def _ensure(self, bit: int) -> None:
        w = bit // _WORD_BITS
        lo, hi = self.base, self.base + len(self.words)
        if lo <= w < hi:
            return
        if not self.words.any():
            self.base, self.words = w, np.zeros(1, np.uint64)
            return
        # grow toward w, at least doubling, so appends stay amortized O(1)
        size = len(self.words)
        if w >= hi:
            new_lo, new_hi = lo, max(w + 1, lo + 2 * size)
        else:
            new_lo, new_hi = max(0, min(w, hi - 2 * size)), hi
        grown = np.zeros(new_hi - new_lo, np.uint64)
        grown[lo - new_lo:hi - new_lo] = self.words
        self.base, self.words = new_lo, grown

    @staticmethod
    def _aligned(a: "Bitset", b: "Bitset") -> Tuple[np.ndarray, np.ndarray, int]:
        if a.base == b.base and len(a.words) == len(b.words):
            return a.words, b.words, a.base
        lo = min(a.base, b.base)
        hi = max(a.base + len(a.words), b.base + len(b.words))
        wa = np.zeros(hi - lo, np.uint64)
        wa[a.base - lo:a.base - lo + len(a.words)] = a.words
        wb = np.zeros(hi - lo, np.uint64)
        wb[b.base - lo:b.base - lo + len(b.words)] = b.words
        return wa, wb, lo

    # -- single-bit ops ----------------------------------------------------
    def set(self, bit: int) -> None:
        self._ensure(bit)
        self.words[bit // _WORD_BITS - self.base] |= (
            np.uint64(1) << np.uint64(bit % _WORD_BITS)
        )

    def clear(self, bit: int) -> None:
        w = bit // _WORD_BITS - self.base
        if 0 <= w < len(self.words):
            self.words[w] &= ~(np.uint64(1) << np.uint64(bit % _WORD_BITS))

    def test(self, bit: int) -> bool:
        w = bit // _WORD_BITS - self.base
        if not 0 <= w < len(self.words):
            return False
        return bool((self.words[w] >> np.uint64(bit % _WORD_BITS)) & np.uint64(1))

    # -- set algebra -------------------------------------------------------
    def __and__(self, other: "Bitset") -> "Bitset":
        wa, wb, base = self._aligned(self, other)
        return Bitset(np.bitwise_and(wa, wb), base)

    def __or__(self, other: "Bitset") -> "Bitset":
        wa, wb, base = self._aligned(self, other)
        return Bitset(np.bitwise_or(wa, wb), base)

    def andnot(self, other: "Bitset") -> "Bitset":
        wa, wb, base = self._aligned(self, other)
        return Bitset(np.bitwise_and(wa, np.bitwise_invert(wb)), base)

    def copy(self) -> "Bitset":
        return Bitset(self.words.copy(), self.base)

    # -- queries -----------------------------------------------------------
    def count(self) -> int:
        return int(np.bitwise_count(self.words).sum())

    def any(self) -> bool:
        return bool(self.words.any())

    def ids(self) -> np.ndarray:
        """Dense int32 array of set bit positions, ascending."""
        bits = np.unpackbits(self.words.view(np.uint8), bitorder="little")
        return (np.flatnonzero(bits) + self.base * _WORD_BITS).astype(np.int32)

    def mask(self, n: int) -> np.ndarray:
        """Boolean mask of length n (the masked-scan form for the device)."""
        bits = np.unpackbits(self.words.view(np.uint8), bitorder="little")
        out = np.zeros(n, bool)
        start = self.base * _WORD_BITS
        m = min(n - start, len(bits))
        if m > 0:
            out[start:start + m] = bits[:m]
        return out

    @classmethod
    def from_ids(cls, ids: Iterable[int]) -> "Bitset":
        ids = np.asarray(list(ids), np.int64)
        if not len(ids):
            return cls()
        base = int(ids.min()) // _WORD_BITS
        words = np.zeros(int(ids.max()) // _WORD_BITS - base + 1, np.uint64)
        np.bitwise_or.at(
            words,
            ids // _WORD_BITS - base,
            np.uint64(1) << (ids % _WORD_BITS).astype(np.uint64),
        )
        return cls(words, base)

    # -- serialization -----------------------------------------------------
    def to_bytes(self) -> bytes:
        """The nonzero window of words. A window starting at word 0 keeps
        the flat form (raw words, trailing zero words trimmed); any other
        is prefixed by ``_WINDOW_TAG`` and its base word index."""
        nz = np.flatnonzero(self.words)
        if not len(nz):
            return b""
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        body = self.words[lo:hi].tobytes()
        base = self.base + lo
        if base == 0:
            return body
        return _WINDOW_TAG + struct.pack("<Q", base) + body

    @classmethod
    def from_bytes(cls, b: bytes) -> "Bitset":
        if not b:
            return cls()
        if len(b) % 8 == 1 and b[:1] == _WINDOW_TAG:
            (base,) = struct.unpack_from("<Q", b, 1)
            return cls(np.frombuffer(b, np.uint64, offset=9).copy(), base)
        return cls(np.frombuffer(b, np.uint64).copy())


def _type_tag(v: Any) -> str:
    # bool before int: bool is an int subclass in Python.
    if isinstance(v, bool):
        return "b"
    if isinstance(v, int):
        return "i"
    if isinstance(v, float):
        return "f"
    return "s"


class InvertedIndex:
    """Per-collection inverted index: field -> value -> Bitset.

    ``string_normalize=True`` reproduces the legacy core variant
    (pkg/index forcedStringTypeChanger): every value is stringified before
    indexing, and lookups compare strings only.
    """

    def __init__(self, fields: Optional[Iterable[str]] = None, *, string_normalize: bool = False):
        self.string_normalize = string_normalize
        self.shards: Dict[str, Dict[Any, Bitset]] = {}
        self.live = Bitset()  # all currently-indexed slots (for NEQ / PureSearch)
        if fields:
            for f in fields:
                self.shards.setdefault(f, {})

    def _norm(self, v: Any) -> Any:
        if self.string_normalize:
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, float) and v == int(v):
                return str(int(v))
            return str(v)
        if isinstance(v, float) and not isinstance(v, bool) and v == int(v):
            # ints arriving as floats (e.g. via JSON/Struct) unify with ints
            return int(v)
        return v

    # -- mutation ----------------------------------------------------------
    def add(self, slot: int, metadata: Dict[str, Any]) -> None:
        for key, value in metadata.items():
            if value is None:
                continue
            self.shards.setdefault(key, {}).setdefault(
                self._norm(value), Bitset()
            ).set(slot)
        self.live.set(slot)

    def remove(self, slot: int, metadata: Optional[Dict[str, Any]] = None) -> None:
        if metadata is not None:
            for key, value in metadata.items():
                if value is None:
                    continue
                vb = self.shards.get(key, {}).get(self._norm(value))
                if vb is not None:
                    vb.clear(slot)
        else:
            for values in self.shards.values():
                for vb in values.values():
                    vb.clear(slot)
        self.live.clear(slot)

    # -- filter evaluation -------------------------------------------------
    @staticmethod
    def _satisfies(stored: Any, op: Op, want: Any) -> bool:
        """Typed comparison for range ops (satisfiesOp parity,
        pkg/inverted/bitmap_index.go:358, compareValues:99)."""
        if isinstance(stored, bool) != isinstance(want, bool):
            return False
        if isinstance(stored, str) != isinstance(want, str):
            return False
        try:
            if op == Op.GT:
                return stored > want
            if op == Op.GTE:
                return stored >= want
            if op == Op.LT:
                return stored < want
            if op == Op.LTE:
                return stored <= want
        except TypeError:
            return False
        return False

    def _eval_leaf(self, f: Filter) -> Bitset:
        values = self.shards.get(f.index_name, {})
        want = self._norm(f.value)
        if f.op == Op.EQ:
            hit = values.get(want)
            return hit.copy() if hit is not None else Bitset()
        if f.op == Op.NEQ:
            hit = values.get(want)
            return self.live.andnot(hit) if hit is not None else self.live.copy()
        if self.string_normalize:
            raise ValueError("range ops unsupported on string-normalized index")
        out = Bitset()
        for stored, vb in values.items():
            if self._satisfies(stored, f.op, want):
                out = out | vb
        return out

    def search(self, expr: FilterExpression) -> Bitset:
        """Evaluate a filter expression tree to a candidate bitset
        (SearchWithExpression parity, pkg/inverted/search.go:50-113)."""
        if isinstance(expr, Filter):
            return self._eval_leaf(expr)
        if isinstance(expr, CompositeFilter):
            if not expr.expressions:
                return Bitset()
            acc = self.search(expr.expressions[0])
            for sub in expr.expressions[1:]:
                nxt = self.search(sub)
                acc = acc & nxt if expr.op == LogicalOp.AND else acc | nxt
            return acc
        raise TypeError(f"not a filter expression: {expr!r}")

    def pure_search(self, filters: Dict[str, Any]) -> Bitset:
        """Exact-match AND over {field: value} (legacy core PureSearch
        parity, pkg/index/search.go:48)."""
        acc = self.live.copy()
        for key, value in filters.items():
            hit = self.shards.get(key, {}).get(self._norm(value))
            if hit is None:
                return Bitset()
            acc = acc & hit
        return acc

    def search_with_candidates(self, candidates: Iterable[int], filters: Dict[str, Any]) -> Bitset:
        """Intersect candidate ids with an exact-match filter (legacy core
        SearchWitCandidates parity, pkg/index/search.go:23)."""
        return Bitset.from_ids(candidates) & self.pure_search(filters)

    # -- serialization -----------------------------------------------------
    def to_bytes(self) -> bytes:
        payload = {
            "string_normalize": self.string_normalize,
            "live": self.live.to_bytes(),
            "shards": {
                fld: [[_type_tag(v), v, vb.to_bytes()] for v, vb in values.items()]
                for fld, values in self.shards.items()
            },
        }
        return msgcodec.packb(payload)

    @classmethod
    def from_bytes(cls, b: bytes) -> "InvertedIndex":
        payload = msgcodec.unpackb(b)
        idx = cls(string_normalize=payload.get("string_normalize", False))
        idx.live = Bitset.from_bytes(payload["live"])
        for fld, entries in payload["shards"].items():
            values: Dict[Any, Bitset] = {}
            for tag, v, raw in entries:
                if tag == "b":
                    v = bool(v)
                elif tag == "i":
                    v = int(v)
                elif tag == "f":
                    v = float(v)
                values[v] = Bitset.from_bytes(raw)
            idx.shards[fld] = values
        return idx
