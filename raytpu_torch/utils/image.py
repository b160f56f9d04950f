"""Image files without PIL: BMP (screenshot parity with SDL_SaveBMP output,
reference: source/Renderer.cpp:184-187) and PNG (8-bit RGB, non-interlaced,
all five row filters on read) through zlib and numpy.

Counterpart of ``raytpu/utils/image.py``, whose PNG path needs PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _check_rgb8(image) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.dtype} {img.shape}")
    return img


def write_bmp(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB to a 24-bit bottom-up BI_RGB BMP."""
    img = _check_rgb8(image)
    h, w, _ = img.shape
    row_size = (w * 3 + 3) & ~3
    pixel_bytes = row_size * h
    rows = np.zeros((h, row_size), np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)  # BGR, bottom-up
    header = struct.pack("<2sIHHIIiiHHIIiiII", b"BM", 14 + 40 + pixel_bytes, 0, 0, 14 + 40,
                         40, w, h, 1, 24, 0, pixel_bytes, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows.tobytes())


def read_bmp(path: str) -> np.ndarray:
    """Read a 24-bit BI_RGB BMP back to (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    w = struct.unpack_from("<i", data, 18)[0]
    h = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp != 24:
        raise ValueError(f"{path}: unsupported bits per pixel {bpp}")
    row_size = (w * 3 + 3) & ~3
    flip = h > 0
    h = abs(h)
    arr = np.frombuffer(data, np.uint8, count=row_size * h, offset=offset)
    arr = arr.reshape(h, row_size)[:, : w * 3].reshape(h, w, 3)
    if flip:
        arr = arr[::-1]
    return arr[:, :, ::-1].copy()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as an 8-bit truecolor PNG (filter 0 rows)."""
    img = _check_rgb8(image)
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit truecolor non-interlaced PNG to (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNG is supported, got "
                         f"depth {depth} color type {color} interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    return _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, 3)).astype(np.uint8)


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth).

    Pixel (y, x) needs its left (a), upper (b) and upper-left (c) neighbours
    already reconstructed, so pixels are swept by anti-diagonal ``x + y = k``:
    every pixel on one diagonal depends only on earlier diagonals, and each
    diagonal is one vectorized step.  Rows are stored skewed, pixel (y, x) at
    column ``x + y + 2`` of row ``y + 1``, so that a diagonal is a column and
    its neighbours are the two columns before it; what is never written is
    the zero padding the filters expect beyond the image's edges."""
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    h, w, _ = filt.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fsk = np.zeros((h, h + w, 3), np.int32)
    fsk[ys, xs + ys] = filt
    sk = np.zeros((h + 1, h + w + 1, 3), np.int32)
    ft = ftype.astype(np.int32)[:, None]
    for k in range(h + w - 1):
        y0, y1 = max(0, k - w + 1), min(h, k + 1)
        a = sk[y0 + 1:y1 + 1, k + 1]
        b = sk[y0:y1, k + 1]
        c = sk[y0:y1, k]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        fy = ft[y0:y1]
        pred = np.select([fy == 1, fy == 2, fy == 3, fy == 4],
                         [a, b, (a + b) // 2, paeth], default=0)
        sk[y0 + 1:y1 + 1, k + 2] = (fsk[y0:y1, k] + pred) & 0xFF
    return sk[ys + 1, xs + ys + 2]


def write_image(path: str, image: np.ndarray) -> None:
    """BMP for a ``.bmp`` path, PNG otherwise."""
    if path.lower().endswith(".bmp"):
        write_bmp(path, image)
    else:
        write_png(path, image)
