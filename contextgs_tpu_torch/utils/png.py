"""8-bit PNG reader and writer on the standard library (`zlib`, `struct`).

The JAX package reads and writes PNG through Pillow; the port needs no
Pillow for PNG. `read_png` gives the array `np.asarray(Image.open(path))`
gives for the PNGs it reads: bit depth 8, colour type 0 (grey, [H,W]), 2
(RGB, [H,W,3]) or 6 (RGBA, [H,W,4]), any of the five filter types, no
interlace. Any other PNG raises `ValueError` naming the file. `write_png`
writes RGB or RGBA uint8 with filter type 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}       # colour type → samples a pixel
COLOR_TYPES = {1: 0, 3: 2, 4: 6}    # and back


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk after the signature; raises on a chunk
    that runs past the end or whose CRC does not match."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise ValueError(f"{path}: PNG has no IEND chunk")


def _unfilter(rows: np.ndarray, height: int, width: int,
              channels: int) -> np.ndarray:
    """Undo the per-row filters of `rows` [H, 1 + W·C] → [H, W, C] uint8.

    Filter 0 on every row is a reshape. Otherwise each pixel depends on its
    left, upper and upper-left neighbours, so the pixels are reconstructed
    one anti-diagonal (y + x constant) at a time: every pixel of a diagonal
    needs only the diagonals before it."""
    ftype = rows[:, 0]
    filt = rows[:, 1:].reshape(height, width, channels).astype(np.int32)
    if not ftype.any():
        return filt.astype(np.uint8)
    # out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are the zeros
    # the filters assume outside the image
    out = np.zeros((height + 1, width + 1, channels), np.int32)
    for d in range(height + width - 1):
        ys = np.arange(max(0, d - width + 1), min(height, d + 1))
        xs = d - ys
        a = out[ys + 1, xs]          # left
        b = out[ys, xs + 1]          # up
        c = out[ys, xs]              # upper left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The 8-bit PNG at `path` as uint8 [H,W] (grey), [H,W,3] or [H,W,4]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); only 8-bit grey, RGB and "
            "RGBA without interlace are read")
    channels = CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (1 + width * channels):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, "
                         f"expected {height * (1 + width * channels)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, 1 + width * channels)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG filter type "
                         f"{int(rows[:, 0].max())}")
    img = _unfilter(rows, height, width, channels)
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a uint8 [H,W,3] or [H,W,4] array, filter 0 every row."""
    img = np.asarray(img)
    if (img.dtype != np.uint8 or img.ndim != 3
            or img.shape[2] not in COLOR_TYPES):
        raise ValueError(f"encode_png takes uint8 [H,W,3] or [H,W,4], got "
                         f"{img.dtype} {img.shape}")
    height, width, channels = img.shape
    rows = np.zeros((height, 1 + width * channels), np.uint8)
    rows[:, 1:] = img.reshape(height, -1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, COLOR_TYPES[channels],
                       0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
