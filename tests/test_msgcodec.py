"""The stdlib MessagePack codec: round trips, byte equality with the
``msgpack`` package (where installed), and its refusals."""

import struct

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from coltt_tpu.utils import msgcodec

_ints = st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
_scalars = (
    st.none() | st.booleans() | _ints
    | st.floats(allow_nan=False) | st.text() | st.binary()
)
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text() | _ints, inner, max_size=20),
    max_leaves=60,
)


@settings(max_examples=200, deadline=None)
@given(_values)
def test_roundtrip(obj):
    assert msgcodec.unpackb(msgcodec.packb(obj)) == obj


@settings(max_examples=200, deadline=None)
@given(_values)
def test_bytes_equal_msgpack(obj):
    msgpack = pytest.importorskip("msgpack")
    assert msgcodec.packb(obj) == msgpack.packb(obj, use_bin_type=True)


@settings(max_examples=200, deadline=None)
@given(_values)
def test_decodes_msgpack_output(obj):
    msgpack = pytest.importorskip("msgpack")
    assert msgcodec.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63,
])
def test_int_width_boundaries(value):
    packed = msgcodec.packb(value)
    assert msgcodec.unpackb(packed) == value
    msgpack = pytest.importorskip("msgpack")
    assert packed == msgpack.packb(value)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_container_length_boundaries(n):
    for obj in ("x" * n, b"y" * n, [1] * n, {str(i): i for i in range(n)}):
        packed = msgcodec.packb(obj)
        assert msgcodec.unpackb(packed) == obj
        msgpack = pytest.importorskip("msgpack")
        assert packed == msgpack.packb(obj, use_bin_type=True)


def test_tuples_and_bytes_like_encode_as_array_and_bin():
    assert msgcodec.unpackb(msgcodec.packb((1, (2, 3)))) == [1, [2, 3]]
    assert msgcodec.unpackb(msgcodec.packb(bytearray(b"ab"))) == b"ab"
    assert msgcodec.unpackb(msgcodec.packb(memoryview(b"cd"))) == b"cd"


def test_reads_float32():
    assert msgcodec.unpackb(b"\xca" + struct.pack(">f", 1.5)) == 1.5


def test_refuses_unknown_python_types():
    with pytest.raises(TypeError):
        msgcodec.packb(object())
    with pytest.raises(OverflowError):
        msgcodec.packb(2 ** 64)


@pytest.mark.parametrize("data", [
    b"",                # nothing
    b"\x92\x01",        # array of 2 with one item
    b"\xa5abc",         # fixstr cut short
    b"\xcd\x01",        # uint16 cut short
    b"\xc4\x05ab",      # bin8 cut short
])
def test_refuses_truncated_data(data):
    with pytest.raises(ValueError):
        msgcodec.unpackb(data)


def test_refuses_extension_types_and_trailing_bytes():
    with pytest.raises(ValueError, match="unsupported"):
        msgcodec.unpackb(b"\xd4\x01\x02")
    with pytest.raises(ValueError, match="extra data"):
        msgcodec.unpackb(b"\x01\x02")
