"""The port's `utils/visualize.py` against the JAX package's on seeded
arrays: byte-equal for every uint8 output (the labels included: both draw
them with Pillow's built-in font), within 1e-6 for the float ones."""

import numpy as np
import pytest

from contextgs_tpu.utils import visualize as jvz
from contextgs_tpu_torch.utils import visualize as tvz


def _equal_u8(got, want):
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("alignment, scale, text", [
    ("top", 1.0, "hello"), ("bottom", 1.0, "normal_p"),
    ("top", 1.5, "PSNR 27.31")], ids=["top", "bottom", "top_scaled"])
def test_add_label_centered_matches_jax(rng, alignment, scale, text):
    img = rng.integers(0, 256, (72, 120, 3)).astype(np.uint8)
    got = tvz.add_label_centered(img, text, scale, alignment, (255, 0, 0))
    _equal_u8(got, jvz.add_label_centered(img, text, scale, alignment,
                                          (255, 0, 0)))
    assert not np.array_equal(got, img)
    with pytest.raises(ValueError):
        tvz.add_label_centered(img, "x", alignment="left")


@pytest.mark.parametrize("bounds", [(None, None), (1.0, 0.0), (0.2, 0.1)],
                         ids=["auto", "unit", "narrow"])
def test_to_rgb8_and_apply_jet_match_jax(rng, bounds):
    x = rng.normal(0.5, 0.4, (9, 11, 3)).astype(np.float32)
    x_max, x_min = bounds
    u8 = tvz.to_rgb8(x, x_max=x_max, x_min=x_min)
    _equal_u8(u8, jvz.to_rgb8(x, x_max=x_max, x_min=x_min))
    _equal_u8(tvz.apply_jet(u8), jvz.apply_jet(u8))              # HWC
    _equal_u8(tvz.apply_jet(u8[..., 0]), jvz.apply_jet(u8[..., 0]))
    ramp = np.arange(256, dtype=np.uint8)
    _equal_u8(tvz.apply_jet(ramp), jvz.apply_jet(ramp))


@pytest.mark.parametrize("case", ["rgb", "gray_2d", "one_channel_jet",
                                  "masked", "labelled"])
def test_array_to_image_matches_jax(rng, case):
    chw = rng.uniform(-0.1, 1.1, (3, 20, 24)).astype(np.float32)
    kw = dict(rgb=dict(x=chw), gray_2d=dict(x=chw[0]),
              one_channel_jet=dict(x=chw[:1], mode="jet", x_max=None,
                                   x_min=None),
              masked=dict(x=chw, mask=rng.random((20, 24)) < 0.5),
              labelled=dict(x=chw, label="depth"))[case]
    _equal_u8(tvz.array_to_image(**kw), jvz.array_to_image(**kw))
    for bad in (dict(x=np.zeros((2, 4, 4))), dict(x=chw, mode="hsv")):
        with pytest.raises(ValueError):
            tvz.array_to_image(**bad)


def _depth_inputs(rng):
    h, w = 16, 20
    depth = (2.0 + rng.normal(0, 0.1, (h, w))).astype(np.float32)
    focal = np.array([[30.0, 0.0], [0.0, 28.0]], np.float32)
    princpt = np.array([w / 2, h / 2], np.float32)
    return depth, focal, princpt


def test_depth_chain_matches_jax(rng):
    """depth_to_cam_positions and normals_from_positions (float) within
    1e-6; visualize_normal (uint8, labelled) byte-equal."""
    depth, focal, princpt = _depth_inputs(rng)
    h, w = depth.shape
    uv = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"),
                  axis=0).astype(np.float32)[None]
    args = (depth[None, None], uv, focal[None], princpt[None])
    pos = tvz.depth_to_cam_positions(*args)
    want_pos = jvz.depth_to_cam_positions(*args)
    assert pos.shape == (1, 3, h, w)
    np.testing.assert_allclose(pos, want_pos, atol=1e-6)
    normals = tvz.normals_from_positions(pos)
    np.testing.assert_allclose(normals, jvz.normals_from_positions(want_pos),
                               atol=1e-6)
    # unit length but for the 1e-5 the reference adds to the norm
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0,
                               atol=5e-3)
    _equal_u8(tvz.visualize_normal(depth, focal, princpt),
              jvz.visualize_normal(depth, focal, princpt))
