"""Image grid / PNG utilities of the port.

``to_uint8``, ``make_grid`` and ``frames_to_grid`` are copies of the
reference's ``utils/images.py``. PNG encoding here uses only the standard library
(zlib), so the port serves PNG grids on hosts without Pillow;
:func:`decode_png` reads back what :func:`encode_png` writes.
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(images: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    """Map NHWC floats in ``value_range`` to uint8."""
    lo, hi = value_range
    x = (np.asarray(images, np.float32) - lo) / max(hi - lo, 1e-8)
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: int = 0) -> np.ndarray:
    """Tile [N, H, W, C] uint8 images into a single [GH, GW, C] grid
    (torchvision ``make_grid`` semantics: ``nrow`` images per row)."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = math.ceil(n / ncol)
    grid = np.full((nrows * (h + padding) + padding,
                    ncol * (w + padding) + padding, c), pad_value, np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        top = r * (h + padding) + padding
        left = col * (w + padding) + padding
        grid[top:top + h, left:left + w] = images[i]
    return grid


def frames_to_grid(frames: Sequence[np.ndarray], value_range=(-1.0, 1.0)
                   ) -> np.ndarray:
    """Sampler intermediates as rows: one row per sample, one column per
    saved frame."""
    stacked = np.stack([np.asarray(f) for f in frames], axis=1)
    n, s, h, w, c = stacked.shape
    flat = to_uint8(stacked.reshape(n * s, h, w, c), value_range)
    return make_grid(flat, nrow=s)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """Encode an [H, W] or [H, W, 1|3|4] uint8 array as PNG bytes."""
    arr = np.asarray(arr, np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    h, w = arr.shape[:2]
    channels = 1 if arr.ndim == 2 else arr.shape[-1]
    color_type = {1: 0, 3: 2, 4: 6}[channels]
    rows = arr.reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG whose rows use filter 0 (what
    :func:`encode_png` writes) into [H, W, C] uint8. Raises ValueError on
    anything else, including a bad chunk checksum."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r} chunk")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG header {ihdr}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    raw = raw.reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError("unsupported PNG row filter")
    return raw[:, 1:].reshape(h, w, channels).copy()


def _grid_uint8(images: np.ndarray, nrow: Optional[int],
                value_range) -> np.ndarray:
    arr = to_uint8(images, value_range)
    if arr.ndim == 4:
        arr = make_grid(arr, nrow or int(math.ceil(math.sqrt(len(arr)))))
    return arr


def save_image(images: np.ndarray, path: str, nrow: Optional[int] = None,
               value_range=(-1.0, 1.0)) -> str:
    """Save a batch (gridded) or single image as PNG."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(encode_png(_grid_uint8(images, nrow, value_range)))
    return str(p)


def to_grid_png_bytes(images: np.ndarray, nrow: Optional[int] = None,
                      value_range=(-1.0, 1.0)) -> bytes:
    """Encode a batch as one PNG grid, in memory (the HTTP server returns
    this as the response body)."""
    return encode_png(_grid_uint8(images, nrow, value_range))
