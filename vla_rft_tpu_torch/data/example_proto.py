"""`tf.train.Example` on the protobuf wire format, without TensorFlow or
protobuf.

The RLDS shards hold one serialized Example per episode.  The messages:

    Example   { Features features = 1; }
    Features  { map<string, Feature> feature = 1; }  // entries: key 1, value 2
    Feature   { oneof kind { BytesList bytes_list = 1; FloatList float_list = 2;
                             Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed = true]; }
    Int64List { repeated int64 value = 1 [packed = true]; }

`parse_example` reads floats and int64s both packed and one value a field
(a parser must take either), skips unknown fields, lets a later map entry of
the same key win and merges repeated lists of one kind, as protobuf does.
`serialize_example` writes what TensorFlow writes: packed lists.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

BYTES, FLOAT, INT64 = "bytes_list", "float_list", "int64_list"
_KIND = {1: BYTES, 2: FLOAT, 3: INT64}
_FIELD = {v: k for k, v in _KIND.items()}

Values = Union[List[bytes], np.ndarray]


def _varint(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise ValueError("truncated varint in tf.train.Example")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes in tf.train.Example")


def _fields(buf: bytes, pos: int, end: int):
    """(field number, wire type, value) of each field in buf[pos:end]: an int
    for varint and fixed fields, a (start, stop) span for length-delimited."""
    while pos < end:
        tag, pos = _varint(buf, pos, end)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos, end)
        elif wire == 1:
            if pos + 8 > end:
                raise ValueError("truncated field in tf.train.Example")
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos, end)
            value, pos = (pos, pos + n), pos + n
        elif wire == 5:
            if pos + 4 > end:
                raise ValueError("truncated field in tf.train.Example")
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise ValueError(f"wire type {wire} in tf.train.Example")
        if pos > end:
            raise ValueError("truncated field in tf.train.Example")
        yield field, wire, value


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _list(buf: bytes, kind: str, start: int, stop: int) -> Values:
    out: list = []
    for field, wire, v in _fields(buf, start, stop):
        if field != 1:
            continue
        if kind == BYTES and wire == 2:
            out.append(bytes(buf[v[0]:v[1]]))
        elif kind == FLOAT and wire == 2:  # packed
            out.append(np.frombuffer(buf[v[0]:v[1]], "<f4"))
        elif kind == FLOAT and wire == 5:
            out.append(np.asarray([v], "<u4").view("<f4"))
        elif kind == INT64 and wire == 2:  # packed
            pos, vals = v[0], []
            while pos < v[1]:
                x, pos = _varint(buf, pos, v[1])
                vals.append(_signed(x))
            out.append(np.asarray(vals, np.int64))
        elif kind == INT64 and wire == 0:
            out.append(np.asarray([_signed(v)], np.int64))
    if kind == BYTES:
        return out
    dtype = np.float32 if kind == FLOAT else np.int64
    return np.concatenate(out).astype(dtype) if out else np.zeros(0, dtype)


def _feature(buf: bytes, start: int, stop: int) -> Tuple[str, Values]:
    kind, values = None, None
    for field, wire, v in _fields(buf, start, stop):
        if field in _KIND and wire == 2:
            new = _list(buf, _KIND[field], *v)
            if kind == _KIND[field]:  # a repeated sub-message merges
                values = values + new if kind == BYTES else np.concatenate([values, new])
            else:  # a later member of the oneof replaces the earlier
                kind, values = _KIND[field], new
    return kind, values


class Example:
    """A parsed tf.train.Example: `features` maps each key to (kind, values),
    kind None for a Feature with no list set.  The accessors read a key as
    TensorFlow's `feature[key].<kind>.value` does: a missing key, or a key
    of another kind, gives an empty list."""

    def __init__(self, features: Dict[str, Tuple[str, Values]]):
        self.features = features

    def _get(self, key: str, kind: str):
        k, values = self.features.get(key, (None, None))
        return values if k == kind else None

    def bytes_list(self, key: str) -> List[bytes]:
        v = self._get(key, BYTES)
        return list(v) if v is not None else []

    def float_list(self, key: str) -> np.ndarray:
        v = self._get(key, FLOAT)
        return v if v is not None else np.zeros(0, np.float32)

    def int64_list(self, key: str) -> np.ndarray:
        v = self._get(key, INT64)
        return v if v is not None else np.zeros(0, np.int64)


def parse_example(raw: bytes) -> Example:
    """Parse one serialized tf.train.Example."""
    feats: Dict[str, Tuple[str, Values]] = {}
    end = len(raw)
    for field, wire, v in _fields(raw, 0, end):
        if field != 1 or wire != 2:
            continue
        for f2, w2, entry in _fields(raw, *v):
            if f2 != 1 or w2 != 2:
                continue
            key, feat = b"", (None, None)
            for f3, w3, span in _fields(raw, *entry):
                if f3 == 1 and w3 == 2:
                    key = bytes(raw[span[0]:span[1]])
                elif f3 == 2 and w3 == 2:
                    feat = _feature(raw, *span)
            feats[key.decode()] = feat
    return Example(feats)


# ------------------------------------------------------------------- writer
def _enc_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _delimited(field: int, payload: bytes) -> bytes:
    return _enc_varint(field << 3 | 2) + _enc_varint(len(payload)) + payload


def _enc_list(kind: str, values) -> bytes:
    if kind == BYTES:
        return b"".join(_delimited(1, bytes(v)) for v in values)
    if kind == FLOAT:
        data = np.asarray(values, np.float32).reshape(-1).astype("<f4").tobytes()
    else:
        data = b"".join(_enc_varint(int(v)) for v in np.asarray(values, np.int64).reshape(-1))
    return _delimited(1, data) if data else b""


def serialize_example(features: Dict[str, Tuple[str, Sequence]]) -> bytes:
    """Serialize {key: (kind, values)} (kind BYTES, FLOAT or INT64) as a
    tf.train.Example, the map in the dict's order, lists packed."""
    entries = []
    for key, (kind, values) in features.items():
        feature = _delimited(_FIELD[kind], _enc_list(kind, values))
        entries.append(_delimited(1, _delimited(1, key.encode()) + _delimited(2, feature)))
    return _delimited(1, b"".join(entries))
