"""Dependency-free TensorBoard event-file writer (the port's own copy of
`contextgs_tpu/utils/tboard.py`).

Hand-encodes the two formats the reader consumes:

- TFRecord framing: <u64 length> <u32 masked-crc32c(length)> <payload>
  <u32 masked-crc32c(payload)>.
- `Event` protobuf with fields wall_time(1, double), step(2, int64),
  file_version(3, string), summary(5, message); `Summary` holds repeated
  `Value`(1) with tag(1, string), simple_value(2, float) or image(4, message);
  `Summary.Image` holds height(1)/width(2)/colorspace(3) varints and
  encoded_image_string(4, bytes — PNG from `utils/png.py`, no Pillow).

Files land under `<logdir>/events.out.tfevents.<ts>.<host>` and open in stock
TensorBoard. Writes are append+flush per call.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from contextgs_tpu_torch.utils.png import encode_png

_CRC_TABLE = []


def _crc32c_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _scalar_value(tag: str, value: float) -> bytes:
    v = (_len_field(1, tag.encode()) +
         _field(2, 5) + struct.pack("<f", float(value)))
    return _len_field(1, v)


def _image_value(tag: str, png: bytes, h: int, w: int, channels: int) -> bytes:
    img = (_field(1, 0) + _varint(h) + _field(2, 0) + _varint(w) +
           _field(3, 0) + _varint(channels) + _len_field(4, png))
    v = _len_field(1, tag.encode()) + _len_field(4, img)
    return _len_field(1, v)


class SummaryWriter:
    """Minimal tensorboard.SummaryWriter stand-in (scalars + images)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%d.%s" % (int(time.time()),
                                              socket.gethostname())
        self._f = open(os.path.join(logdir, name), "ab")
        self._event(_len_field(3, b"brain.Event:2"))

    def _event(self, body: bytes, step: int | None = None):
        ev = _field(1, 1) + struct.pack("<d", time.time())
        if step is not None:
            ev += _field(2, 0) + _varint(int(step) & (1 << 64) - 1)
        ev += body
        rec = struct.pack("<Q", len(ev))
        self._f.write(rec + struct.pack("<I", _masked_crc(rec)) + ev +
                      struct.pack("<I", _masked_crc(ev)))
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int):
        self._event(_len_field(5, _scalar_value(tag, value)), step)

    def add_image(self, tag: str, hwc, step: int):
        """hwc: float array in [0,1] or uint8, shape [H,W,3] or [H,W]."""
        arr = np.asarray(hwc)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None].repeat(3, axis=2)
        self._event(_len_field(5, _image_value(
            tag, encode_png(arr), arr.shape[0], arr.shape[1], arr.shape[2])),
            step)

    def close(self):
        self._f.close()
