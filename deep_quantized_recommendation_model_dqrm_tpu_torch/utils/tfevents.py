"""Minimal TensorBoard tfevents writer — no TensorFlow dependency.

The reference writes real tfevents via torch's SummaryWriter
(dlrm_s_pytorch.py:1497-1498, :1650) so standard dashboards can read the
training curves; our JSONL ScalarLogger is private. This module emits the
actual tfevents wire format by hand:

- file = sequence of TFRecords:
    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)
- data = serialized `tensorflow.Event` proto. Only the fields TensorBoard's
  scalar dashboard needs are encoded (wall_time, step, file_version,
  Summary.Value{tag, simple_value}) — hand-rolled protobuf wire encoding,
  ~40 lines, no deps.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — TFRecord framing checksum. zlib.crc32 is CRC32/IEEE,
# a different polynomial, so we carry the 256-entry table ourselves.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire encoding (just what tensorflow.Event needs)
# ---------------------------------------------------------------------------


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


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    val = _len_delim(1, tag.encode()) + _field(2, 5) + struct.pack("<f", value)
    summary = _len_delim(1, val)  # Summary { repeated Value value = 1 }
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 }
    return (
        _field(1, 1)
        + struct.pack("<d", wall_time)
        + _field(2, 0)
        + _varint(step & 0xFFFFFFFFFFFFFFFF)
        + _len_delim(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1, file_version = 3 (string) }
    return (
        _field(1, 1)
        + struct.pack("<d", wall_time)
        + _len_delim(3, b"brain.Event:2")
    )


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


class TFEventWriter:
    """Scalar event writer producing files TensorBoard loads directly."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = (
            f"events.out.tfevents.{time.time():.6f}."
            f"{socket.gethostname()}{filename_suffix}"
        )
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._f.write(_record(_version_event(time.time())))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(
            _record(_scalar_event(time.time(), int(step), tag, float(value)))
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.flush()
            self._f.close()
            self._f = None
