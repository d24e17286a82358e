"""Tone mapping and image I/O (reference src/main.zig:395-405).

The tone map runs on the framebuffer's device; encoding runs on the host
through the native encoder (`utils/native.py`, built at first use with the
host C++ compiler), never Pillow. The readers of 8-bit PNG and PPM
(`read_png`, `read_ppm`, `read_rgb`) need only zlib and numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from rtweekend_tpu_torch.utils import native


def tonemap(accum: torch.Tensor, samples_per_pixel: int) -> torch.Tensor:
    """radiance-sum [H, W, 3] -> uint8 [H, W, 3]: mean over samples, gamma 2
    via sqrt, clamp [0, 0.999], floor(256*c) (main.zig:395-400)."""
    return (256.0 * tonemap_f(accum, samples_per_pixel)).to(torch.uint8)


def tonemap_f(accum: torch.Tensor, samples_per_pixel: int) -> torch.Tensor:
    """Float tone map before quantization."""
    scale = 1.0 / samples_per_pixel
    return torch.clamp(torch.sqrt(accum * scale), 0.0, 0.999)


def write_ppm(path, pixels_u8):
    """Plain-text P3 PPM, written by the native encoder (utils/native.py)."""
    with open(path, "wb") as f:
        f.write(native.ppm_encode(pixels_u8))


def write_png(path, pixels_u8):
    """8-bit RGB PNG, Paeth-filtered rows at deflate level 6, written by the
    native encoder (utils/native.py): the JAX package's bytes."""
    with open(path, "wb") as f:
        f.write(native.png_encode(pixels_u8))


def _png_chunks(data: bytes):
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    i = 8
    while i + 8 <= len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        tag = data[i + 4:i + 8]
        chunk = data[i + 8:i + 8 + n]
        if len(chunk) != n:
            raise ValueError(f"truncated PNG chunk {tag!r}")
        yield tag, chunk
        i += 12 + n


def _unfilter(filt, ftype, bpp: int):
    """PNG reconstruction (PNG spec §9) of filtered rows [H, W, bpp] uint8
    with per-row filter types [H] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).
    A byte depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal row + column = k are independent: the loop
    runs over the H + W - 1 diagonals, each step vectorised over the rows."""
    h, w = filt.shape[:2]
    rec = np.zeros((h + 1, w + 1, bpp), dtype=np.int32)   # row 0, col 0: zeros
    filt = filt.astype(np.int32)
    ftype = np.asarray(ftype)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        c = k - r
        a = rec[r + 1, c]          # left
        b = rec[r, c + 1]          # up
        ul = rec[r, c]             # upper left
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, c + 1] = (filt[r, c] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode an 8-bit RGB or RGBA, non-interlaced PNG to uint8 [H, W, 3]
    (alpha dropped) with zlib alone; every filter type. Other PNGs
    (palette, grey, 16-bit, interlaced) raise ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat = None, []
    for tag, chunk in _png_chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif tag == b"IDAT":
            idat.append(chunk)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or color not in (2, 6) or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNG is read "
                         f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    bpp = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h}x{bpp}")
    rows = raw.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: unknown PNG filter type {int(ftype.max())}")
    return _unfilter(rows[:, 1:].reshape(h, w, bpp), ftype, bpp)[..., :3]


def read_ppm(path) -> np.ndarray:
    """Decode a P3 (text) or P6 (binary) PPM with maxval 255 to uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, i = [], 0
    while len(tokens) < 4:         # magic, width, height, maxval; '#' comments
        while data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            i = data.index(b"\n", i) + 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"{path}: maxval {maxval}; only 255 is read")
    n = w * h * 3
    if magic == b"P6":
        px = np.frombuffer(data[i + 1:i + 1 + n], dtype=np.uint8)
    elif magic == b"P3":
        px = np.array(data[i:].split(), dtype=np.int64)
        if px.size and (px.min() < 0 or px.max() > 255):
            raise ValueError(f"{path}: sample out of [0, 255]")
    else:
        raise ValueError(f"{path}: not a P3 or P6 PPM (magic {magic!r})")
    if px.size != n:
        raise ValueError(f"{path}: {px.size} samples for {w}x{h}x3")
    return px.astype(np.uint8).reshape(h, w, 3)


def read_rgb(path) -> np.ndarray:
    """uint8 [H, W, 3] of a .ppm (read_ppm) or any other file as PNG (read_png)."""
    return read_ppm(path) if str(path).lower().endswith(".ppm") else read_png(path)


def read_image_rgba(path):
    """Decode an image file to uint8 RGBA [H, W, 4] (needs Pillow)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)
