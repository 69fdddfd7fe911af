"""8-bit grayscale PNG files with the standard library (``zlib``,
``struct``), so that no host needs PIL: ``encode_gray_png`` writes one
IDAT chunk of unfiltered rows, ``decode_gray_png`` reads such files back
(and any non-interlaced 8-bit grayscale PNG with the five standard
filters)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_gray_png(gray: np.ndarray) -> bytes:
    """(H, W) uint8 -> PNG bytes (color type 0, bit depth 8)."""
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), gray], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_gray_png(data: bytes) -> np.ndarray:
    """PNG bytes of an 8-bit grayscale, non-interlaced image -> (H, W)
    uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 0, 0):
        raise ValueError(f"only 8-bit grayscale non-interlaced PNGs, got "
                         f"depth {depth}, color type {color}")
    raw = zlib.decompress(idat)
    out = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.int64)
    for y in range(h):
        f = raw[y * (w + 1)]
        row = np.frombuffer(raw, np.uint8, w, y * (w + 1) + 1).astype(np.int64)
        if f == 1:
            for x in range(1, w):
                row[x] = (row[x] + row[x - 1]) & 255
        elif f == 2:
            row = (row + prev) & 255
        elif f == 3:
            for x in range(w):
                left = row[x - 1] if x else 0
                row[x] = (row[x] + (left + prev[x]) // 2) & 255
        elif f == 4:
            for x in range(w):
                left = row[x - 1] if x else 0
                up_left = prev[x - 1] if x else 0
                row[x] = (row[x] + _paeth(left, prev[x], up_left)) & 255
        out[y] = row
        prev = row
    return out

