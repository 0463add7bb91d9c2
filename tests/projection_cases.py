"""Projection inputs for the tests of `ops/rasterize/projection.py`: a small
scene whose rows take every branch of the projection and of its gradient,
and scenes at the sizes the renderer projects. numpy and the port only (no
JAX), so the card tests can use them too."""

import math

import numpy as np
import torch

from contextgs_tpu_torch.ops.rasterize.projection import OPACITY_MIN
from contextgs_tpu_torch.ops.rasterize.reference import _projection_terms
from contextgs_tpu_torch.scene.cameras import make_camera

# rows of branch_scene and the branch each takes
BRANCH_ROWS = dict(behind=0, near=1, at_zero=2, past_x=(3, 4), past_y=(5, 6),
                   on_x_bounds=(7, 8), needles=range(9, 15), faint=(15, 16))


def camera(width, height, fov_x=1.0, R=None, T=None) -> dict:
    """world_view, full_proj (float32 [4,4]), tanfovx, tanfovy (floats)."""
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * height / width)
    cam = make_camera(0, np.eye(3) if R is None else R,
                      np.zeros(3) if T is None else T, fov_x, fov_y, width,
                      height).as_device_dict()
    return dict(world_view=np.asarray(cam["world_view"], np.float32),
                full_proj=np.asarray(cam["full_proj"], np.float32),
                tanfovx=float(cam["tanfovx"]), tanfovy=float(cam["tanfovy"]))


def _gaussians(rng, n, lo, hi, scale_range):
    means = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return means, scales, quats


def _needles(cam, width, height, count, scale_modifier, seed=20):
    """`count` long thin gaussians whose 2D determinant the plain chain
    rounds to <= 0 (its a·c and b² cancel) at `scale_modifier`, found in a
    seeded pool."""
    rng = np.random.default_rng(seed)
    n = 400
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(1.5, 5, n)], 1).astype(np.float32)
    scales = np.stack([10 ** rng.uniform(1, 3, n), np.full(n, 1e-4),
                       np.full(n, 1e-4)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    det = _projection_terms(
        torch.from_numpy(means), torch.from_numpy(scales),
        torch.from_numpy(quats), torch.from_numpy(cam["world_view"]),
        torch.from_numpy(cam["full_proj"]), cam["tanfovx"], cam["tanfovy"],
        width, height, scale_modifier)["det"].numpy()
    pick = np.flatnonzero(det <= 0)[:count]
    assert len(pick) == count, "the needle pool lost its det <= 0 rows"
    return means[pick], scales[pick], quats[pick]


def branch_scene(width=48, height=32, n=160, seed=0,
                 scale_modifier=1.0) -> dict:
    """Gaussians in front of an identity camera, and rows (BRANCH_ROWS)
    behind it (z -1), in front of the z 0.2 cull, at |z| < 1e-6 (the safe
    z), past the 1.3·tanfov clamp on both sides in x and in y, on the clamp's
    bounds in x (z 1, so x/z is the bound itself), needles whose determinant
    rounds to <= 0 at `scale_modifier`, and opacities under 1/255; every 7th
    row invalid."""
    cam = camera(width, height)
    rng = np.random.default_rng(seed)
    means, scales, quats = _gaussians(rng, n, -0.8, 0.8, (0.02, 0.12))
    means[:, 2] = rng.uniform(1.5, 5.0, n)
    means[:9] = [[0.1, 0.1, -1.0], [0.1, -0.1, 0.1], [0.1, 0.2, 3e-7],
                 [3.0, 0.0, 2.0], [-3.0, 0.0, 2.0], [0.0, 3.0, 2.0],
                 [0.0, -3.0, 2.0], [0.0, 0.1, 1.0], [0.0, -0.1, 1.0]]
    lim = np.float32(1.3 * cam["tanfovx"])
    means[7, 0], means[8, 0] = lim, -lim
    rows = BRANCH_ROWS["needles"]
    means[rows], scales[rows], quats[rows] = _needles(
        cam, width, height, len(rows), scale_modifier)
    opac = rng.uniform(0.3, 1.0, n).astype(np.float32)
    opac[list(BRANCH_ROWS["faint"])] = [0.5 * OPACITY_MIN, 0.0]
    valid = np.arange(n) % 7 != 3
    return dict(cam=cam, width=width, height=height, means=means,
                scales=scales, quats=quats, opac=opac, valid=valid)


def volume_scene(n, width, height, seed, fov_x=1.2, radius=4.0,
                 scale_range=(0.002, 0.05)) -> dict:
    """n gaussians in the cube [-2, 2]³ seen from an orbit camera at
    `radius` (the benchmark's serve and train views), a tenth of them
    invalid; its integer outputs are what a render bins."""
    rng = np.random.default_rng(seed)
    means, scales, quats = _gaussians(rng, n, -2.0, 2.0, scale_range)
    ang = rng.uniform(0, 2 * np.pi)
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    return dict(cam=camera(width, height, fov_x, R, np.array([0, 0, radius])),
                width=width, height=height, means=means, scales=scales,
                quats=quats, opac=rng.uniform(0, 1, n).astype(np.float32),
                valid=rng.random(n) >= 0.1)


def cotangents(n, seed, with_depths=True):
    """Seeded cotangents of means2d [n,2], conics [n,3] and depths [n]."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 2)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=n).astype(np.float32) if with_depths else None)


def grad_errors(got, want, row_tol=None) -> list:
    """What fails of the kernel's gradient bounds, leaf by leaf, against
    `want`: ‖g − w‖ ≤ 1e-5·‖w‖, no element off by more than 1e-4 of the
    leaf's largest, finite wherever `want` is; with `row_tol`, each row
    within row_tol of its own norm too. Empty where all hold."""
    bad = []
    for name, g, w in zip(("means3d", "scales", "quats"), got, want):
        g, w = g.double(), w.double()
        fin = torch.isfinite(w)
        if not bool(torch.isfinite(g[fin]).all()):
            bad.append(f"{name}: not finite where the plain chain is")
        g, w = torch.where(fin, g, 0.0), torch.where(fin, w, 0.0)
        diff = (g - w).norm() / w.norm()
        worst = (g - w).abs().max() / w.abs().max()
        if not (diff <= 1e-5 and worst <= 1e-4):
            bad.append(f"{name}: norm {float(diff):.3g}, element "
                       f"{float(worst):.3g}")
        if row_tol is not None:
            row = ((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)).max()
            if not row <= row_tol:
                bad.append(f"{name}: row {float(row):.3g}")
    return bad
