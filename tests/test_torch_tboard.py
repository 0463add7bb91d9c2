"""PyTorch port against the JAX reference in the TensorBoard writer (CPU):
CRC-32C, scalar events byte for byte, and image events whose PNG decodes to
the same pixels (the port encodes it without Pillow)."""

import struct

import numpy as np
import pytest
from PIL import Image

from contextgs_tpu.utils import tboard as jtb
from contextgs_tpu_torch.utils import png
from contextgs_tpu_torch.utils import tboard as ttb


def test_crc32c_vectors():
    """RFC 3720 B.4 vectors, and JAX's value on random bytes."""
    assert ttb.crc32c(b"") == 0
    assert ttb.crc32c(b"123456789") == 0xE3069283
    assert ttb.crc32c(bytes(32)) == 0x8A9136AA
    assert ttb.crc32c(bytes([0xFF] * 32)) == 0x62A8AB43
    assert ttb.crc32c(bytes(range(32))) == 0x46DD794E
    data = np.random.default_rng(0).integers(0, 256, 1000,
                                             dtype=np.uint8).tobytes()
    assert ttb.crc32c(data) == jtb.crc32c(data)


@pytest.fixture
def frozen_clock(monkeypatch):
    """The same wall time and host name in both packages' writers."""
    for mod in (jtb, ttb):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")


def _write(mod, logdir, image=None):
    w = mod.SummaryWriter(str(logdir))
    for step, v in ((0, 1.5), (100, -2.25), (2 ** 40, 3e-7)):
        w.add_scalar("train/psnr", v, step)
        w.add_scalar("total_points", int(v * 1000), step)
    if image is not None:
        w.add_image("test/render", image, 7)
    w.close()
    (path,) = logdir.iterdir()
    return path


def test_scalar_events_match_jax(tmp_path, frozen_clock):
    a = _write(jtb, tmp_path / "jax")
    b = _write(ttb, tmp_path / "port")
    assert a.name == b.name
    assert a.read_bytes() == b.read_bytes()


def _event_png(data: bytes) -> bytes:
    start = data.index(png.SIGNATURE)
    return data[start:data.index(b"IEND", start) + 8]


@pytest.mark.parametrize("kind", ["float_rgb", "uint8_rgb", "grey"])
def test_image_event_decodes_to_jax_pixels(kind, tmp_path, frozen_clock):
    rng = np.random.default_rng(1)
    image = {"float_rgb": rng.random((12, 17, 3)).astype(np.float32),
             "uint8_rgb": rng.integers(0, 256, (12, 17, 3), dtype=np.uint8),
             "grey": rng.random((12, 17))}[kind]
    a = _write(jtb, tmp_path / "jax", image).read_bytes()
    b = _write(ttb, tmp_path / "port", image).read_bytes()
    pa, pb = _event_png(a), _event_png(b)
    (tmp_path / "a.png").write_bytes(pa)
    (tmp_path / "b.png").write_bytes(pb)
    want = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "b.png")),
                                  want)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "b.png")), want)
    # every record before the image's is the same, and every record's
    # framing checks out
    ra, rb = _records(a), _records(b)
    assert len(ra) == len(rb) and ra[:-1] == rb[:-1]


def _records(data: bytes) -> list:
    """The payloads of a TFRecord file, checking each masked CRC."""
    out, pos = [], 0
    while pos < len(data):
        head = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == \
            ttb._masked_crc(head)
        body = data[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] == \
            ttb._masked_crc(body)
        out.append(body)
        pos += 16 + n
    return out
