"""A PNG reader with zlib and NumPy alone: 8-bit RGB or RGBA, not
interlaced, every filter type (PNG specification, section 9)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _unfilter(filt, ftype, bpp: int):
    """Rows [H, W, bpp] as stored, filter types [H] -> the pixels. A byte
    depends on its left, upper and upper-left neighbours, so the bytes of
    one anti-diagonal (row + column = k) are independent: the loop runs
    over the diagonals, each step vectorised over its rows."""
    h, w = filt.shape[:2]
    rec = np.zeros((h + 1, w + 1, bpp), dtype=np.int32)
    filt = filt.astype(np.int32)
    ftype = np.asarray(ftype)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        c = k - r
        a, b, ul = rec[r + 1, c], rec[r, c + 1], rec[r, c]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4], [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, c + 1] = (filt[r, c] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read(path) -> np.ndarray:
    """uint8 [H, W, 3] of a PNG file (alpha dropped); ValueError for a file
    this reader does not cover."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    i, ihdr, idat = 8, None, []
    while i + 8 <= len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        tag, chunk = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if len(chunk) != n:
            raise ValueError(f"{path}: truncated chunk {tag!r}")
        if zlib.crc32(tag + chunk) != struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif tag == b"IDAT":
            idat.append(chunk)
        elif tag == b"IEND":
            break
        i += 12 + n
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or color not in (2, 6) or interlace != 0:
        raise ValueError(f"{path}: not an 8-bit RGB(A) non-interlaced PNG")
    bpp = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h}x{bpp}")
    rows = raw.reshape(h, 1 + w * bpp)
    if (rows[:, 0] > 4).any():
        raise ValueError(f"{path}: unknown filter type")
    return _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0], bpp)[..., :3]
