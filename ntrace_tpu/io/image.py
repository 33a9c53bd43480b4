"""Framebuffer/image I/O: tonemap + PNG/BMP/TGA/TIFF (~ framework/io/
ImageLodePngIO.*, ImageBmpIO.*, ImageTargaIO.*, ImageTiffIO.*; expected
paths, mount empty -- SURVEY.md SS3.1).

The reference ships four hand-written codecs for screenshots and texture
loading. PNG, the renderer's own output, is written here with zlib and
struct alone (write_png/read_png); PIL covers the other formats through one
dispatch pair (write_image/read_image). Images are (H, W, 3) float32
linear in [0, inf) on the render side, uint8 on disk."""

from __future__ import annotations

import struct
import zlib

import numpy as np

FORMATS = (".png", ".bmp", ".tga", ".tif", ".tiff")


def tonemap(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Linear float -> uint8 with clamp + gamma (matches a plain GL blit
    with sRGB-ish gamma; the reference displays linear values clamped)."""
    x = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
    x = x ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray, gamma: float = 2.2) -> None:
    """8-bit RGB PNG (uint8 passthrough or tonemapped float)."""
    arr = img if img.dtype == np.uint8 else tonemap(img, gamma)
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    # Filter type 0 (None) in front of every scanline.
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an unfiltered 8-bit RGB PNG as write_png writes it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, color = hdr[:4]
    if (depth, color) != (8, 2):
        raise ValueError(f"{path}: only 8-bit RGB PNGs are supported")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy()


def write_image(path: str, img: np.ndarray, gamma: float = 2.2) -> None:
    """Write PNG/BMP/TGA/TIFF by file suffix (uint8 passthrough or
    tonemapped float)."""
    import os

    from PIL import Image

    ext = os.path.splitext(str(path))[1].lower()
    if ext not in FORMATS:
        raise ValueError(f"unsupported image format {ext!r}; use {FORMATS}")
    arr = img
    if arr.dtype != np.uint8:
        arr = tonemap(arr, gamma)
    Image.fromarray(arr).save(path)


def read_image(path: str) -> np.ndarray:
    """Read any supported format as (H, W, 3) uint8 (textures,
    golden-image comparisons)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def checksum(img: np.ndarray) -> str:
    """Stable content hash of a float image (golden-image fingerprints)."""
    import hashlib

    a = np.ascontiguousarray(np.asarray(img, dtype=np.float32))
    return hashlib.sha1(a.tobytes()).hexdigest()[:16]
