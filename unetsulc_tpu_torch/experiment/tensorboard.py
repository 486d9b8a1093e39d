"""Minimal, dependency-free TensorBoard scalar event writer.

A copy of ``unetsulc_tpu/experiment/tensorboard.py``. The reference logs
``Loss/{train,val}`` and ``Accuracy/{train,val}`` per epoch per fold
through ``torch.utils.tensorboard.SummaryWriter`` (ref
training.py:160-162,231-232), which needs the ``tensorboard`` package;
this writer produces the same ``events.out.tfevents.*`` files (TFRecord
framing with masked CRC32C and hand-encoded Event/Summary protobufs) with
nothing but the standard library.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _event(
    wall_time: float,
    step: int = 0,
    file_version: Optional[str] = None,
    tag: Optional[str] = None,
    simple_value: Optional[float] = None,
) -> bytes:
    # Event proto: 1=wall_time(double) 2=step(int64) 3=file_version(string)
    # 5=summary(Summary); Summary.Value: 1=tag(string) 2=simple_value(float)
    ev = _field_double(1, wall_time)
    if step:
        ev += _field_varint(2, step)
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if tag is not None:
        value = _field_bytes(1, tag.encode()) + _field_float(2, simple_value)
        ev += _field_bytes(5, _field_bytes(1, value))
    return ev


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


class SummaryWriter:
    """Drop-in for the two reference calls: add_scalar + close."""

    _seq = 0

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        SummaryWriter._seq += 1
        fname = "events.out.tfevents.%010d.%s.%d.%d" % (
            int(time.time()),
            socket.gethostname(),
            os.getpid(),
            SummaryWriter._seq,
        )
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(
            _record(
                _event(
                    time.time(), step=int(step), tag=tag,
                    simple_value=float(value),
                )
            )
        )
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
