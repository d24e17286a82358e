"""Tone mapping and image I/O (reference src/main.zig:395-405).

The tone map runs on the framebuffer's device; encoding runs on the host
with Pillow when it is installed, else a minimal zlib PNG encoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def tonemap(accum: torch.Tensor, samples_per_pixel: int) -> torch.Tensor:
    """radiance-sum [H, W, 3] -> uint8 [H, W, 3]: mean over samples, gamma 2
    via sqrt, clamp [0, 0.999], floor(256*c) (main.zig:395-400)."""
    return (256.0 * tonemap_f(accum, samples_per_pixel)).to(torch.uint8)


def tonemap_f(accum: torch.Tensor, samples_per_pixel: int) -> torch.Tensor:
    """Float tone map before quantization."""
    scale = 1.0 / samples_per_pixel
    return torch.clamp(torch.sqrt(accum * scale), 0.0, 0.999)


def write_ppm(path, pixels_u8):
    """Plain-text P3 PPM."""
    arr = np.asarray(pixels_u8)
    h, w, _ = arr.shape
    lines = [f"P3\n{w} {h}\n255\n"]
    lines.extend(f"{r} {g} {b}\n" for r, g, b in arr.reshape(-1, 3))
    with open(path, "w") as f:
        f.writelines(lines)


def write_png(path, pixels_u8):
    """PNG encode with Pillow if installed, else the built-in encoder."""
    arr = np.ascontiguousarray(np.asarray(pixels_u8), dtype=np.uint8)
    try:
        from PIL import Image
    except ImportError:
        _write_png_minimal(path, arr)
        return
    Image.fromarray(arr).save(path, format="PNG")


def _png_chunk(tag, data):
    chunk = tag + data
    return struct.pack(">I", len(data)) + chunk + struct.pack(
        ">I", zlib.crc32(chunk) & 0xFFFFFFFF
    )


def _write_png_minimal(path, arr):
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 9)))
        f.write(_png_chunk(b"IEND", b""))


def read_image_rgba(path):
    """Decode an image file to uint8 RGBA [H, W, 4] (needs Pillow)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)
