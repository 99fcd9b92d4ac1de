"""Image decoding for the encode worker, on the standard library, numpy and torch.

The reference decodes an image part with PIL: `Image.open(...)
.convert("RGB").resize((S, S), Image.BILINEAR)` (`llm/multimodal.py`).
The machine with the card has no PIL, so the port decodes PNG itself:

  * `decode_png`: PNG with `zlib` and the five row filters (None, Sub, Up,
    Average, Paeth), non-interlaced, colour types grey (bit depth 1, 2, 4
    or 8), RGB, palette (1, 2, 4 or 8), grey + alpha and RGBA (8). The
    result is RGB as PIL's `convert("RGB")` gives it: alpha is dropped, not
    composited; grey is repeated over the three channels, sub-byte grey
    scaled to 0..255.
  * `resize_rgb`: `torch.nn.functional.interpolate(mode="bilinear",
    antialias=True, align_corners=False)`, rounded and clamped to uint8 as
    PIL keeps uint8. Against PIL's BILINEAR every value lands within one
    grey level; an image already at the target size is returned as it is.

Anything else (JPEG, GIF, WebP, BMP, TIFF, Adam7 interlacing, 16-bit
samples) raises `ValueError` naming what it is: a refusal, not a guess.

Sub, Average and Paeth depend on the byte to the left, Up, Average and
Paeth on the row above, so the filters are undone along anti-diagonals of
the image (every pixel of one diagonal depends only on the two before
it), vectorised over the diagonal.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
NO_DECODER = "the port decodes PNG only (the card's machine has no image decoder)"


def sniff_format(data: bytes) -> str:
    """The image format a payload's magic bytes name ("unknown" if none)."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return "unknown"


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("PNG chunk is cut short")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n  # length, type, body, CRC


def unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The filtered scanlines (a filter-type byte before each row) ->
    reconstructed bytes [height, row_bytes] uint8. `bpp`: bytes a complete
    pixel (at least 1), the distance to the "left" byte."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < height * (row_bytes + 1):
        raise ValueError("PNG image data is cut short")
    rows = buf[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} is not one of 0-4")
    W = row_bytes // bpp
    # A skewed copy: diagonal d = x + y is S[d + 2] and row y its column
    # y + 1. Left, up and up-left of a diagonal's pixels are then contiguous
    # slices of the two diagonals before it; the slots no pixel fills
    # (x < 0, y < 0, x >= W) stay zero, as the filters want.
    Y, X = np.mgrid[0:height, 0:W]
    Fs = np.zeros((height + W + 1, height + 1, bpp), np.int16)
    Fs[X + Y + 2, Y + 1] = filt.reshape(height, W, bpp)
    S = np.zeros_like(Fs)
    t = ftype[:, None]
    for d in range(height + W - 1):
        lo, hi = max(0, d - W + 1), min(height - 1, d)
        a, b, c = S[d + 1, lo + 1:hi + 2], S[d + 1, lo:hi + 1], S[d, lo:hi + 1]
        tt = t[lo:hi + 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(tt == 4, paeth, np.where(tt == 3, (a + b) >> 1,
                        np.where(tt == 2, b, np.where(tt == 1, a, 0))))
        S[d + 2, lo + 1:hi + 2] = (Fs[d + 2, lo + 1:hi + 2] + pred) & 0xFF
    return S[X + Y + 2, Y + 1].astype(np.uint8).reshape(height, row_bytes)


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Reconstructed bytes -> samples [height, width, channels] uint8 (sub-
    byte samples unpacked, most significant bits first; not yet scaled)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # MSB first
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file -> RGB [height, width, 3] uint8 (see the module docstring
    for what is decoded and what is refused)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"image format {sniff_format(data)} is not decoded: {NO_DECODER}")
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, ctype, comp, filt_method, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not a PNG colour type")
    if depth not in DEPTHS[ctype]:
        raise ValueError(
            f"PNG bit depth {depth} (colour type {ctype}) is not decoded: {NO_DECODER}; "
            f"depths {DEPTHS[ctype]} are")
    if interlace:
        raise ValueError(f"interlaced (Adam7) PNG is not decoded: {NO_DECODER}")
    if comp or filt_method:
        raise ValueError("PNG compression or filter method other than 0")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG has no PLTE chunk")
    ch = CHANNELS[ctype]
    row_bytes = (width * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    rows = unfilter(zlib.decompress(b"".join(idat)), height, row_bytes, bpp)
    px = _samples(rows, width, depth, ch)
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError("palette PNG indexes past its PLTE chunk")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        grey = px[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])  # RGB, RGBA: alpha dropped


def resize_rgb(rgb: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """RGB [H, W, 3] uint8 -> [size[0], size[1], 3] uint8 by antialiased
    bilinear interpolation (PIL's BILINEAR within one grey level)."""
    if rgb.shape[:2] == tuple(size):
        return rgb
    x = torch.from_numpy(np.ascontiguousarray(rgb)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=tuple(size), mode="bilinear", antialias=True,
                      align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def load_rgb(data: bytes, size: int) -> np.ndarray:
    """An image payload -> RGB [size, size, 3] uint8: decoded, then resized."""
    return resize_rgb(decode_png(data), (size, size))

