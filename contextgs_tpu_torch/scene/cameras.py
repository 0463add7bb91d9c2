"""Camera containers with precomputed view/projection transforms; the port's
copy of `contextgs_tpu/scene/cameras.py` (`Camera`, `MiniCam`).

A host-side dataclass of numpy arrays; `as_device_dict()` packs the fields a
render needs, and the renderer moves them to its device. `world_view` and
`full_proj` are stored TRANSPOSED (row-vector convention, `x_row @ M`), and
`camera_center = inv(world_view)[3, :3]`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from contextgs_tpu_torch.utils.graphics import (perspective_projection,
                                                world_to_view)

ZNEAR = 0.01
ZFAR = 100.0


@dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray                  # [3,3] camera→world rotation (COLMAP style)
    T: np.ndarray                  # [3] world→camera translation
    fov_x: float
    fov_y: float
    image: Optional[np.ndarray]    # [H,W,3] float32 in [0,1], or None (pose-only)
    image_name: str = ""
    width: int = 0
    height: int = 0
    znear: float = ZNEAR
    zfar: float = ZFAR
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    world_view: np.ndarray = field(init=False)   # [4,4] transposed W2V
    projection: np.ndarray = field(init=False)   # [4,4] transposed proj
    full_proj: np.ndarray = field(init=False)    # [4,4] world_view @ projection
    camera_center: np.ndarray = field(init=False)

    def __post_init__(self):
        if self.image is not None:
            self.image = np.clip(self.image, 0.0, 1.0).astype(np.float32)
            self.height, self.width = self.image.shape[:2]
        w2v = world_to_view(self.R, self.T, self.trans, self.scale)
        proj = perspective_projection(self.znear, self.zfar, self.fov_x, self.fov_y)
        self.world_view = w2v.T.astype(np.float32)
        self.projection = proj.T.astype(np.float32)
        self.full_proj = (self.world_view @ self.projection).astype(np.float32)
        self.camera_center = np.linalg.inv(self.world_view)[3, :3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fov_x * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fov_y * 0.5)

    def as_device_dict(self) -> dict:
        """Camera fields a render reads (H/W are passed separately)."""
        return dict(
            world_view=self.world_view,
            full_proj=self.full_proj,
            camera_center=self.camera_center,
            tanfovx=np.float32(self.tanfovx),
            tanfovy=np.float32(self.tanfovy),
        )


def make_camera(uid: int, R: np.ndarray, T: np.ndarray, fov_x: float, fov_y: float,
                width: int, height: int, image: Optional[np.ndarray] = None,
                **kw) -> Camera:
    return Camera(uid=uid, colmap_id=uid, R=R, T=T, fov_x=fov_x, fov_y=fov_y,
                  image=image, width=width, height=height, **kw)


@dataclass
class MiniCam:
    """Pose-only camera built from pre-composed transforms (the live
    viewer): the client ships the transposed `world_view` and `full_proj`,
    so nothing is recomputed here but the camera centre. `as_device_dict`
    gives `Camera`'s keys, so `models/renderer.render` takes either."""
    width: int
    height: int
    fov_x: float
    fov_y: float
    znear: float
    zfar: float
    world_view: np.ndarray         # [4,4] transposed W2V (row-vector conv.)
    full_proj: np.ndarray          # [4,4] transposed world→clip
    camera_center: np.ndarray = field(init=False)

    def __post_init__(self):
        self.world_view = np.asarray(self.world_view, np.float32)
        self.full_proj = np.asarray(self.full_proj, np.float32)
        self.camera_center = np.linalg.inv(
            self.world_view)[3, :3].astype(np.float32)

    tanfovx = Camera.tanfovx
    tanfovy = Camera.tanfovy
    as_device_dict = Camera.as_device_dict
