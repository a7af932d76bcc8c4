"""TFRecord files of ``tf.train.Example`` records, read and written
without TensorFlow.

A TFRecord file is a sequence of records, each framed as

    uint64 length | uint32 masked_crc32c(length) | payload | uint32 masked_crc32c(payload)

(little endian; ``masked(c) = ((c >> 15) | (c << 17)) + 0xa282ead8``).
The reader checks both checksums and raises ``ValueError`` on a mismatch
or a truncated record.

An ``Example`` is ``Features{ map<string, Feature> }`` in protobuf wire
format; a ``Feature`` holds one of ``bytes_list`` (field 1), ``float_list``
(field 2) or ``int64_list`` (field 3). Floats and int64s are read in both
the packed form (one length-delimited run, which TF writes) and the
unpacked form (one tagged value each); the writer writes the packed form.
``parse_example`` gives ``{name: list of bytes | float32 array | int64
array}``. CRC32C runs in the port's codec library
(``emmax_torch/data/codec.py``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, Sequence, Union

import numpy as np

from emmax_torch.data import codec

Value = Union[Sequence[bytes], np.ndarray]
_MASK_DELTA = 0xA282EAD8


def masked_crc(data: bytes) -> int:
    c = codec.crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def read_records(path) -> Iterator[bytes]:
    """The payloads of a TFRecord file, in order."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"{path}: truncated record header")
            length_bytes = head[:8]
            (length,) = struct.unpack("<Q", length_bytes)
            (crc,) = struct.unpack("<I", head[8:])
            if masked_crc(length_bytes) != crc:
                raise ValueError(f"{path}: length CRC mismatch")
            payload = f.read(length)
            tail = f.read(4)
            if len(payload) < length or len(tail) < 4:
                raise ValueError(f"{path}: truncated record")
            if masked_crc(payload) != struct.unpack("<I", tail)[0]:
                raise ValueError(f"{path}: payload CRC mismatch")
            yield payload


class TFRecordWriter:
    """Writes framed records; use as a context manager."""

    def __init__(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        length = struct.pack("<Q", len(payload))
        self._f.write(length + struct.pack("<I", masked_crc(length)))
        self._f.write(payload + struct.pack("<I", masked_crc(payload)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --- protobuf wire format ----------------------------------------------------

def _varint(buf: bytes, pos: int) -> tuple:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _put_varint(out: bytearray, v: int) -> None:
    v &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(buf: bytes) -> Iterator[tuple]:
    """(field number, wire type, value) of a message; a length-delimited
    value is a memoryview, a fixed32 its 4 bytes, a varint an int."""
    view = memoryview(buf)
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            if pos + n > len(buf):
                raise ValueError("truncated length-delimited field")
            value = view[pos:pos + n]
            pos += n
        elif wire == 5:
            value = view[pos:pos + 4]
            pos += 4
        elif wire == 1:
            value = view[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, value


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _parse_feature(buf) -> Value:
    for kind, _, body in _fields(bytes(buf)):
        body = bytes(body)
        if kind == 1:
            return [bytes(v) for f, _, v in _fields(body) if f == 1]
        if kind == 2:
            parts = []
            for f, wire, v in _fields(body):
                if f == 1:
                    parts.append(np.frombuffer(v, "<f4"))   # packed or one
            return (np.concatenate(parts) if parts
                    else np.zeros(0, np.float32)).astype(np.float32)
        if kind == 3:
            vals = []
            for f, wire, v in _fields(body):
                if f != 1:
                    continue
                if wire == 0:
                    vals.append(_signed64(v))
                else:                                   # packed run
                    raw, pos = bytes(v), 0
                    while pos < len(raw):
                        x, pos = _varint(raw, pos)
                        vals.append(_signed64(x))
            return np.asarray(vals, np.int64)
    return []


def parse_example(payload: bytes) -> Dict[str, Value]:
    """A serialized ``tf.train.Example`` as ``{name: values}``."""
    out: Dict[str, Value] = {}
    for f, _, features in _fields(payload):
        if f != 1:
            continue
        for g, _, entry in _fields(bytes(features)):
            if g != 1:
                continue
            key, value = None, b""
            for h, _, v in _fields(bytes(entry)):
                if h == 1:
                    key = bytes(v).decode()
                elif h == 2:
                    value = v
            if key is not None:
                out[key] = _parse_feature(value)
    return out


def _len_field(out: bytearray, field: int, body: bytes) -> None:
    _put_varint(out, (field << 3) | 2)
    _put_varint(out, len(body))
    out += body


def serialize_example(features: Dict[str, Value]) -> bytes:
    """``{name: list of bytes | float array | int array}`` as a serialized
    ``tf.train.Example`` (floats as float32, ints as int64, both packed)."""
    feats = bytearray()
    for key, values in features.items():
        feature = bytearray()
        if isinstance(values, (list, tuple)) and all(
                isinstance(v, (bytes, bytearray)) for v in values):
            lst = bytearray()
            for v in values:
                _len_field(lst, 1, bytes(v))
            _len_field(feature, 1, bytes(lst))
        else:
            arr = np.asarray(values)
            lst = bytearray()
            if arr.dtype.kind == "f":
                _len_field(lst, 1, arr.astype("<f4").reshape(-1).tobytes())
                _len_field(feature, 2, bytes(lst))
            elif arr.dtype.kind in "iub":
                packed = bytearray()
                for v in arr.reshape(-1).tolist():
                    _put_varint(packed, int(v))
                _len_field(lst, 1, bytes(packed))
                _len_field(feature, 3, bytes(lst))
            else:
                raise TypeError(f"feature {key!r}: dtype {arr.dtype}")
        entry = bytearray()
        _len_field(entry, 1, key.encode())
        _len_field(entry, 2, bytes(feature))
        _len_field(feats, 1, bytes(entry))
    example = bytearray()
    _len_field(example, 1, bytes(feats))
    return bytes(example)
