"""TensorBoard scalar writer on the standard library, for machines without
the ``tensorboard`` package; the JAX Runner writes the same scalars through
``torch.utils.tensorboard.SummaryWriter``.

A file ``events.out.tfevents.<time>.<host>.<pid>`` holds TFRecords: a
little-endian u64 length, the masked CRC-32C of those 8 bytes, the data,
then the masked CRC-32C of the data. Each record is a hand-encoded
``tensorflow.Event`` proto: the first carries ``file_version``
"brain.Event:2", each later one ``wall_time``, ``step`` and a ``Summary``
with one ``Value`` of ``tag`` and ``simple_value``, as ``add_scalar``
writes them. Each record is flushed as it is written."""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord frame around `data`."""
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1              # int64 fields encode negatives in 10
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def event_bytes(wall_time: float, step: int | None = None,
                file_version: str | None = None,
                tag: str | None = None, value: float | None = None) -> bytes:
    """An Event proto: wall_time (1, double), step (2, int64), file_version
    (3, string), summary (5: Summary.value (1): tag (1), simple_value (2,
    float))."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _varint(2 << 3 | 0) + _varint(int(step))
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if tag is not None:
        val = (_len_field(1, tag.encode()) + _varint(2 << 3 | 5)
               + struct.pack("<f", float(value)))
        out += _len_field(5, _len_field(1, val))
    return out


class EventWriter:
    """``add_scalar(tag, value, step)`` and ``close()``, as
    ``SummaryWriter`` has them, writing into `log_dir`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now):010d}."
                     f"{socket.gethostname()}.{os.getpid()}")
        self._f = open(self.path, "ab")
        self._write(event_bytes(now, file_version="brain.Event:2"))

    def _write(self, data: bytes):
        self._f.write(tfrecord(data))
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int):
        self._write(event_bytes(time.time(), step=step, tag=tag,
                                value=float(value)))

    def close(self):
        if not self._f.closed:
            self._f.close()
