"""TFRecord framing (port of vla_rft_tpu/data/tfrecord.py).

A record is an 8-byte little-endian length, the masked crc32c of those 8
bytes, the payload and the masked crc32c of the payload.  The scanner and the
writer are `csrc/tfrecord_reader.cc` (a copy of the root csrc's), built at
first use by `ops/cuda_build.py`; payloads are sliced from an mmap of the
file.  The pure-Python scanner and crc32c below are its plain twin
(`plain=True`): the tests hold the library against it, and the library never
falls back to it.
"""
from __future__ import annotations

import ctypes
import mmap
import struct
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from vla_rft_tpu_torch.ops import cuda_build

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("tfrecord_reader")
        lib.tfrecord_scan.restype = ctypes.c_long
        lib.tfrecord_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_int,
        ]
        lib.tfrecord_write.restype = ctypes.c_long
        lib.tfrecord_write.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p]
        _lib = lib
    return _lib


# ----------------------------------------------------------- the plain twin
def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """crc32c (Castagnoli), a byte at a time from the library's table."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _scan_plain(buf, verify_crc: bool) -> List[Tuple[int, int]]:
    """The library's scan in Python: the same records, the same errors (a
    truncated record, and with verify_crc a wrong length or payload crc)."""
    out, pos, size = [], 0, len(buf)
    while pos + 12 <= size:
        (length,) = struct.unpack_from("<Q", buf, pos)
        start = pos + 12
        if start + length + 4 > size:
            raise ValueError("corrupt tfrecord: truncated record")
        if verify_crc:
            (len_crc,) = struct.unpack_from("<I", buf, pos + 8)
            (data_crc,) = struct.unpack_from("<I", buf, start + length)
            if (masked_crc(bytes(buf[pos:pos + 8])) != len_crc
                    or masked_crc(bytes(buf[start:start + length])) != data_crc):
                raise ValueError("corrupt tfrecord: crc mismatch")
        out.append((start, length))
        pos = start + length + 4
    return out


def _frame_plain(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return b"".join((header, struct.pack("<I", masked_crc(header)), payload,
                     struct.pack("<I", masked_crc(payload))))


# ------------------------------------------------------------------ the API
def _scan(buf, verify_crc: bool) -> List[Tuple[int, int]]:
    size = len(buf)
    if size == 0:
        return []
    arr = np.frombuffer(buf, np.uint8)
    max_n = max(16, size // 16)  # a record takes at least 16 bytes
    offs = (ctypes.c_long * max_n)()
    lens = (ctypes.c_long * max_n)()
    n = _load().tfrecord_scan(arr.ctypes.data, size, offs, lens, max_n, int(verify_crc))
    del arr  # releases the buffer before the caller closes it
    if n < 0:
        raise ValueError("corrupt tfrecord: truncated record or crc mismatch")
    return [(offs[i], lens[i]) for i in range(n)]


def scan_records(path: str, verify_crc: bool = False,
                 plain: bool = False) -> List[Tuple[int, int]]:
    """[(offset, length)] of the record payloads in a TFRecord file."""
    with open(path, "rb") as f:
        buf = f.read()
    return _scan_plain(buf, verify_crc) if plain else _scan(buf, verify_crc)


def read_records(path: str, verify_crc: bool = False, plain: bool = False) -> Iterator[bytes]:
    """The payloads of a TFRecord file, in order, each as bytes."""
    with open(path, "rb") as f:
        if f.seek(0, 2) == 0:
            return
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            spans = _scan_plain(mm, verify_crc) if plain else _scan(mm, verify_crc)
            for off, length in spans:
                yield mm[off:off + length]


def write_records(path: str, payloads: Sequence[bytes], plain: bool = False) -> None:
    """Write `payloads` as TFRecord frames (the library's framing, or with
    `plain` the twin's)."""
    with open(path, "wb") as f:
        for p in payloads:
            if plain:
                f.write(_frame_plain(p))
                continue
            out = ctypes.create_string_buffer(len(p) + 16)
            n = _load().tfrecord_write(p, len(p), out)
            f.write(out.raw[:n])
