"""Dependency-free TensorBoard event-file writer (port of
``stif_tpu/utils/tb.py``).

The reference's optional TensorBoard logging (``use_tb_logger``,
``codes/options/train/train_zsm.yml:3``; ``log_tensorboard``,
``codes/myutils.py:283-288``) without a ``tensorboard`` package: the
on-disk format written directly, TFRecord framing (length + masked CRC32C)
around hand-encoded ``Event`` / ``Summary`` protobufs, scalar summaries
only, which is all the reference logs. Stock TensorBoard reads the files.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ----------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_string(field: int, s: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(s)) + s


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(wall_time: float, step: int = 0, file_version: str = None,
           summary: bytes = None) -> bytes:
    # Event: 1=wall_time double, 2=step int64, 3=file_version, 5=summary
    msg = _pb_double(1, wall_time)
    if step:
        msg += _pb_int64(2, step)
    if file_version is not None:
        msg += _pb_string(3, file_version.encode())
    if summary is not None:
        msg += _pb_string(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary: repeated 1=Value{1=tag string, 2=simple_value float}
    val = _pb_string(1, tag.encode()) + _pb_float(2, float(value))
    return _pb_string(1, val)


class TBWriter:
    """Minimal SummaryWriter: ``add_scalar(tag, value, step)``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.{:.0f}.{}".format(
            time.time(), socket.gethostname())
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes):
        hdr = struct.pack("<Q", len(record))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(_event(time.time(), step=step,
                           summary=_scalar_summary(tag, value)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_events(path: str):
    """Parse an event file back (for tests / offline inspection without
    TensorBoard). Returns a list of dicts; scalar events carry
    ``{"step": int, "tag": str, "value": float}``."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (n,) = struct.unpack("<Q", hdr)
            (crc_h,) = struct.unpack("<I", f.read(4))
            if crc_h != _masked_crc(hdr):
                raise ValueError("corrupt length crc")
            data = f.read(n)
            (crc_d,) = struct.unpack("<I", f.read(4))
            if crc_d != _masked_crc(data):
                raise ValueError("corrupt data crc")
            out.append(_parse_event(data))
    return out


def _read_varint(buf, i):
    n, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _parse_event(buf: bytes) -> dict:
    i, ev = 0, {}
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 1:
            (v,) = struct.unpack("<d", buf[i:i + 8])
            i += 8
            if field == 1:
                ev["wall_time"] = v
        elif wire == 0:
            v, i = _read_varint(buf, i)
            if field == 2:
                ev["step"] = v
        elif wire == 2:
            n, i = _read_varint(buf, i)
            sub = buf[i:i + n]
            i += n
            if field == 3:
                ev["file_version"] = sub.decode()
            elif field == 5:  # summary -> first value
                j = 0
                while j < len(sub):
                    k, j = _read_varint(sub, j)
                    if k >> 3 == 1 and k & 7 == 2:
                        m, j = _read_varint(sub, j)
                        val = sub[j:j + m]
                        j += m
                        p = 0
                        while p < len(val):
                            kk, p = _read_varint(val, p)
                            if kk >> 3 == 1 and kk & 7 == 2:
                                q, p = _read_varint(val, p)
                                ev["tag"] = val[p:p + q].decode()
                                p += q
                            elif kk >> 3 == 2 and kk & 7 == 5:
                                (ev["value"],) = struct.unpack(
                                    "<f", val[p:p + 4])
                                p += 4
                            else:
                                break
                    else:
                        break
        else:
            break
    return ev
