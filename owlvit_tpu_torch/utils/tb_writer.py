"""Minimal TensorBoard scalar writer (pure Python, zero dependencies).

The reference imports `SummaryWriter` and advertises TensorBoard in its
README but never constructs one (reference src/util.py:7, README.md:46-50 —
SURVEY §5.9 quirk #6). This makes the capability real: the trainer can emit
standard `events.out.tfevents.*` files that TensorBoard reads directly,
without depending on tensorflow/tensorboardX.

The format is a TFRecord stream of serialized `tensorflow.Event` protos.
Both layers are small enough to hand-encode:

  TFRecord framing (tensorflow/core/lib/io/record_writer.cc):
      uint64 length (LE) | uint32 masked_crc32c(length bytes) |
      data bytes         | uint32 masked_crc32c(data)
      masked_crc = rotr15(crc32c(x)) + 0xa282ead8  (mod 2^32)

  Event proto (tensorflow/core/util/event.proto), fields used here:
      1: double wall_time     2: int64 step
      3: string file_version  5: Summary summary
  Summary.value -> Value { 1: string tag, 2: float simple_value }

Only scalar summaries are emitted — exactly what the reference's (dead)
usage promised: per-epoch loss/mAP curves.

The port's copy of owlvit_tpu/utils/tb_writer.py; tests/test_torch_run.py
holds the bytes it writes equal to the original's.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# --- crc32c (Castagnoli), table-driven software implementation -------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire encoding (varint / fixed64 / length-delimited) -----------


def _varint(n: int) -> bytes:
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
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    out = _double(1, wall_time)
    if step is not None:
        out += _int64(2, step)
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    if summary is not None:
        out += _bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _bytes(1, tag.encode()) + _float(2, float(value))
    return _bytes(1, val)  # Summary.value is field 1 (repeated)


class TBWriter:
    """Append-only scalar event writer; one file per instance."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.v2"
        )
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "wb")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(
            _event(time.time(), step=step, summary=_scalar_summary(tag, value))
        )

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        for k, v in values.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue  # non-scalar (per-class arrays etc.)
            self.scalar(prefix + k, v, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_events(path: str):
    """Parse a tfevents file back into [(step, tag, value)] — the test
    oracle for the writer (and a dependency-free way to inspect logs)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("corrupt tfevents: header crc mismatch")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != _masked_crc(data):
                raise ValueError("corrupt tfevents: data crc mismatch")
            out.extend(_parse_event(data))
    return out


def _read_varint(data: bytes, i: int):
    n = shift = 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(data: bytes):
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 1:
            v, i = data[i : i + 8], i + 8
        elif wire == 5:
            v, i = data[i : i + 4], i + 4
        elif wire == 2:
            ln, i = _read_varint(data, i)
            v, i = data[i : i + ln], i + ln
        else:  # pragma: no cover - groups unused
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _parse_event(data: bytes):
    step, summary = 0, None
    for field, _w, v in _fields(data):
        if field == 2:
            step = v
        elif field == 5:
            summary = v
    if summary is None:
        return []
    out = []
    for field, _w, v in _fields(summary):
        if field != 1:
            continue
        tag, value = None, None
        for f2, _w2, v2 in _fields(v):
            if f2 == 1:
                tag = v2.decode()
            elif f2 == 2:
                (value,) = struct.unpack("<f", v2)
        if tag is not None and value is not None:
            out.append((step, tag, value))
    return out
