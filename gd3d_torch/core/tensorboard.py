"""TensorBoard event files without TensorFlow (the port's counterpart of
gd3d's `tf.summary.create_file_writer` + `tf.summary.scalar` under
--tensorboard, gd3d/cli/train.py).

A file is a sequence of TFRecords: the data's length as a little-endian
u64, the masked CRC32C of those 8 bytes, the data, the masked CRC32C of the
data. Each record is one `Event` protobuf, encoded here by hand: first one
with `file_version "brain.Event:2"`, then one per scalar, `Event{wall_time,
step, summary}` whose single value is what TF2's `tf.summary.scalar`
writes: a rank-0 `DT_FLOAT` tensor (its 4 bytes in `tensor_content`) with
`metadata.plugin_data.plugin_name = "scalars"`. TensorBoard reads these
files as it reads TF's.

`read_events` reads a file back, checking every CRC, for tests and smoke
runs that have no tensorboard package.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Iterator, List, Tuple

_CRC32C_POLY = 0x82F63B78  # Castagnoli, reflected


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask: rotate right by 15, add a constant."""
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 fields: negatives as two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int = 0, file_version: str | None = None,
                 scalar: Tuple[str, float] | None = None) -> bytes:
    """One Event: wall_time (1, double), step (2, int64), file_version (3)
    or summary (5) with one TF2 scalar value (tag 1, tensor 8, metadata 9)."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        tensor = (_key(1, 0) + _varint(1)            # dtype DT_FLOAT
                  + _bytes_field(2, b"")              # tensor_shape: rank 0
                  + _bytes_field(4, struct.pack("<f", value)))  # tensor_content
        metadata = _bytes_field(1, _bytes_field(1, b"scalars"))  # plugin_data
        value_msg = (_bytes_field(1, tag.encode()) + _bytes_field(8, tensor)
                     + _bytes_field(9, metadata))
        out += _bytes_field(5, _bytes_field(1, value_msg))
    return out


def frame_record(data: bytes) -> bytes:
    """TFRecord framing of one record."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


class EventWriter:
    """Scalars into one event file under `logdir`, named as TF names its
    (events.out.tfevents.<time>.<host>.<pid>.0.v2). Not thread-safe."""

    def __init__(self, logdir: str | Path):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = logdir / (f"events.out.tfevents.{int(now)}.{socket.gethostname()}."
                              f"{os.getpid()}.0.v2")
        self._file = open(self.path, "ab")
        self._file.write(frame_record(encode_event(now, file_version="brain.Event:2")))
        self._file.flush()

    def scalars(self, step: int, values: dict) -> None:
        """One scalar event per (tag, value), at `step`."""
        now = time.time()
        for tag, value in values.items():
            self._file.write(frame_record(encode_event(now, step, scalar=(tag, float(value)))))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_records(path: str | Path) -> Iterator[bytes]:
    """The records of a TFRecord file; raises ValueError on a CRC mismatch or
    a truncated record."""
    data = Path(path).read_bytes()
    i = 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {i}")
        length_bytes = data[i:i + 8]
        (n,) = struct.unpack("<Q", length_bytes)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc32c(length_bytes):
            raise ValueError(f"{path}: length CRC mismatch at byte {i}")
        rec = data[i + 12:i + 12 + n]
        if len(rec) != n or i + 16 + n > len(data):
            raise ValueError(f"{path}: truncated record at byte {i}")
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc32c(rec):
            raise ValueError(f"{path}: data CRC mismatch at byte {i}")
        yield rec
        i += 16 + n


def _fields(msg: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field, wire type, value) of a protobuf message: varints as ints,
    fixed64 and fixed32 as raw bytes, length-delimited as bytes."""
    i = 0
    while i < len(msg):
        key, i = _read_varint(msg, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(msg, i)
        elif wire == 1:
            value, i = msg[i:i + 8], i + 8
        elif wire == 5:
            value, i = msg[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(msg, i)
            value, i = msg[i:i + n], i + n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _read_varint(msg: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = msg[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def read_events(path: str | Path) -> Tuple[str, List[Tuple[int, str, float]]]:
    """(file_version, [(step, tag, value) of every scalar event]) of a file
    this module wrote (or TF2's scalars); every CRC is checked."""
    version, scalars = "", []
    for rec in read_records(path):
        step = 0
        for field, _, value in _fields(rec):
            if field == 2:
                step = value
            elif field == 3:
                version = value.decode()
            elif field == 5:
                for _, _, v in _fields(value):  # Summary.value
                    tag, x = "", None
                    for f, _, part in _fields(v):
                        if f == 1:
                            tag = part.decode()
                        elif f == 8:  # TensorProto: tensor_content (4) or float_val (5)
                            for tf_, _, t in _fields(part):
                                if tf_ in (4, 5):
                                    (x,) = struct.unpack("<f", t[:4])
                    scalars.append((step, tag, x))
    return version, scalars
