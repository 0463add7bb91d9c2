"""Scene description handed to training (port of
`contextgs_tpu/scene/dataset_readers.py::SceneInfo`).

Only the container for now: the COLMAP and Blender loaders, which read
images with Pillow, come with the drivers slice (ROADMAP.md queue 1,
slice 6). A caller builds a `SceneInfo` in memory from `scene.cameras.Camera`
objects whose `image` holds the target.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from contextgs_tpu_torch.scene.cameras import Camera


@dataclass
class SceneInfo:
    points: np.ndarray            # [N,3]
    colors: np.ndarray            # [N,3] in [0,1]
    normals: np.ndarray           # [N,3]
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    translate: np.ndarray = field(default_factory=lambda: np.zeros(3))
    radius: float = 1.0
    ply_path: str = ""
