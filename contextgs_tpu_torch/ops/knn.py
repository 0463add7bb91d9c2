"""k-nearest-neighbor mean squared distance (port of
`contextgs_tpu/ops/knn.py::mean_knn_sq_dist`).

The reference's `distCUDA2(points)`: for each point, the mean of squared
distances to its 3 nearest neighbors. Used once at scene init for the auto
voxel size and the initial log-scales, so it runs on the host (cKDTree).
"""

from __future__ import annotations

import numpy as np


def mean_knn_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """[N,3] → [N] mean squared distance to the k nearest neighbors (host)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, dtype=np.float64)
    tree = cKDTree(pts)
    # k+1 because the nearest hit is the point itself
    d, _ = tree.query(pts, k=k + 1, workers=-1)
    return np.mean(d[:, 1:] ** 2, axis=1)
