"""Visualization helpers: labels, colormaps, depth→normal maps (port of
`contextgs_tpu/utils/visualize.py`).

numpy, as the JAX package's: the jet colormap is the analytic jet ramp
(visually equivalent to OpenCV's COLORMAP_JET, not bit-identical), text
labels use Pillow's built-in bitmap font (Pillow is imported inside
`add_label_centered` only), and the depth→camera-space→normal chain is
plain numpy.

Arrays are channel-first [C,H,W] unless noted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["add_label_centered", "to_rgb8", "apply_jet", "array_to_image",
           "depth_to_cam_positions", "normals_from_positions",
           "visualize_normal"]


def add_label_centered(img: np.ndarray, text: str, scale: float = 1.0,
                       alignment: str = "top",
                       color: Tuple[int, int, int] = (0, 255, 0)) -> np.ndarray:
    """Draw `text` horizontally centered at the top or bottom of an HWC
    uint8 image."""
    from PIL import Image, ImageDraw, ImageFont

    img = np.ascontiguousarray(img.astype(np.uint8))
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    try:
        font = ImageFont.load_default(size=int(16 * scale))
    except TypeError:     # older Pillow: fixed-size default font
        font = ImageFont.load_default()
    x0, y0, x1, y1 = draw.textbbox((0, 0), text, font=font)
    tw, th = x1 - x0, y1 - y0
    if alignment == "top":
        pos = ((img.shape[1] - tw) // 2, 50 - th)
    elif alignment == "bottom":
        pos = ((img.shape[1] - tw) // 2, img.shape[0] - 2 * th)
    else:
        raise ValueError("Unknown text alignment")
    draw.text(pos, text, fill=tuple(color), font=font)
    return np.asarray(pil)


def to_rgb8(x: np.ndarray, x_max: Optional[float] = None,
            x_min: Optional[float] = None) -> np.ndarray:
    """Affinely map `x` into uint8 [0,255]."""
    x = np.asarray(x, np.float32)
    if x_min is None:
        x_min = float(x.min())
    if x_max is None:
        x_max = float(x.max())
    gain = 255.0 / np.clip(x_max - x_min, 1e-3, None)
    return np.clip((x - x_min) * gain, 0.0, 255.0).astype(np.uint8)


def apply_jet(u8: np.ndarray) -> np.ndarray:
    """uint8 [...] → RGB jet colormap [..., 3] uint8 (the analytic jet
    ramp)."""
    t = np.asarray(u8, np.float32) / 255.0
    if t.ndim >= 3 and t.shape[-1] == 3:    # HWC input: collapse channels
        t = t[..., 0]
    r = np.clip(1.5 - np.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * t - 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


def array_to_image(x: np.ndarray, x_max: Optional[float] = 1.0,
                   x_min: Optional[float] = 0.0, mode: str = "rgb",
                   mask: Optional[np.ndarray] = None,
                   label: Optional[str] = None) -> np.ndarray:
    """[C,H,W] (or [H,W]) array → HWC uint8 display image: optional mask
    multiply, 1→3 channel broadcast, normalize, optional jet colormap,
    optional centered label."""
    x = np.asarray(x, np.float32)
    if mask is not None:
        x = x * np.asarray(mask, np.float32)
    if x.ndim == 2:
        x = x[None]
    assert x.ndim == 3, x.shape
    if x.shape[0] == 1:
        x = np.repeat(x, 3, axis=0)
    elif x.shape[0] != 3:
        raise ValueError(f"Unsupported number of channels {x.shape[0]}.")
    img = np.transpose(x, (1, 2, 0))
    img = to_rgb8(img, x_max=x_max, x_min=x_min)
    if mode == "jet":
        img = apply_jet(img)
    elif mode != "rgb":
        raise ValueError(f"Unsupported mode {mode}.")
    if label is not None:
        img = add_label_centered(img, label)
    return img


def depth_to_cam_positions(d: np.ndarray, screen_coords: np.ndarray,
                           focal: np.ndarray, princpt: np.ndarray) -> np.ndarray:
    """Unproject a depth map to camera-space positions, batched:
    d [B,1,H,W], screen_coords [B,2,H,W], focal [B,2,2], princpt [B,2] →
    [B,3,H,W]."""
    p = screen_coords - princpt[:, :, None, None]
    x = d * p[:, 0:1] / focal[:, 0:1, 0, None, None]
    y = d * p[:, 1:2] / focal[:, 1:2, 1, None, None]
    return np.concatenate([x, y, d], axis=1)


def normals_from_positions(p: np.ndarray) -> np.ndarray:
    """Central-difference surface normals from camera-space positions:
    [B,3,H,W] → unit normals [B,3,H,W]."""
    pp = np.pad(p, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="edge")
    d0 = pp[:, :, 2:, 1:-1] - pp[:, :, :-2, 1:-1]
    d1 = pp[:, :, 1:-1, 2:] - pp[:, :, 1:-1, :-2]
    n = np.cross(d0, d1, axisa=1, axisb=1, axisc=1)
    norm = np.linalg.norm(n, axis=1, keepdims=True) + 1e-5
    return -n / norm


def visualize_normal(depth: np.ndarray, focal: np.ndarray,
                     princpt: np.ndarray, label: str = "normal_p") -> np.ndarray:
    """Depth map [H,W] → labeled normal-map image."""
    h, w = depth.shape
    uv = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"),
                  axis=0).astype(np.float32)[None]
    pos = depth_to_cam_positions(depth[None, None].astype(np.float32), uv,
                                 focal[None].astype(np.float32),
                                 princpt[None].astype(np.float32))
    normal = 0.5 * (normals_from_positions(pos) + 1.0)
    return array_to_image(normal[0], label=label)
