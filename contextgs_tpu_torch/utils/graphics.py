"""Camera/projection math (numpy, host-side); the port's copy of
`contextgs_tpu/utils/graphics.py` for what the renderer and the scene
loaders need.

Conventions: world-to-view is COLMAP-style (R stored transposed, t as-is), the
projection matrix is the 3DGS one (z_sign=+1, row 3 carries +z so
w_clip = z_view), and matrices are used *row-vector* style downstream
(``x_row @ M``).
"""

from __future__ import annotations

import math

import numpy as np


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world→camera matrix with optional recentering of the camera center.

    R is the COLMAP rotation (camera→world), t the world→camera translation.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def perspective_projection(znear: float, zfar: float,
                           fov_x: float, fov_y: float) -> np.ndarray:
    """3DGS-style perspective matrix.

    NDC x,y in [-1,1]; z maps to zfar/(zfar-znear) - zfar*znear/((zfar-znear) z);
    w_clip = z_view (z_sign = +1).
    """
    tan_y = math.tan(fov_y / 2)
    tan_x = math.tan(fov_x / 2)
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w,x,y,z) quaternion → 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
