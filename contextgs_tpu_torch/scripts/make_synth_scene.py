"""Build the hard synthetic benchmark scene (port of the JAX package's
`scripts/make_synth_scene.py`), with the same geometry, textures and orbit
from `--seed`:

- a textured room (floor + 3 walls), a central textured sphere, a
  torus-like ring and floating semi-transparent occluder blobs;
- `--gauss` ground-truth gaussians with procedural high-frequency textures;
- `--cams` cameras on a jittered orbit looking at the scene centre, written
  as a binary COLMAP model;
- an SfM stand-in: a noisy subsample of the true gaussian means
  (points3D.bin), and the ground truth itself in `oracle.npz`.

The ground truth is rendered by the port's rasterizer (K1 on the card) and
written as PNG by `utils/png.py`. It runs on the CUDA card, or raises where
there is none; `--force_cpu` renders on the CPU. `--budget` is refused: the
port sizes its instance lists per render.

    python -m contextgs_tpu_torch.scripts.make_synth_scene --out <dir> \
        [--res 512] [--cams 120] [--gauss 80000] [--points 120000]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

from contextgs_tpu_torch.config import NO_BUDGET
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers import Refused
from contextgs_tpu_torch.ops.rasterize import rasterize
from contextgs_tpu_torch.scene import colmap
from contextgs_tpu_torch.scene.cameras import Camera
from contextgs_tpu_torch.utils.graphics import qvec_to_rotmat
from contextgs_tpu_torch.utils.png import write_png


def tex(p, k1, k2, phase):
    """Procedural high-frequency rgb texture over 3D points [N,3]."""
    a = np.sin(p[:, 0] * k1 + phase) * np.cos(p[:, 1] * k2)
    b = np.sin((p[:, 1] + p[:, 2]) * k2 * 0.7 + 2 * phase)
    c = ((np.floor(p[:, 0] * k1) + np.floor(p[:, 2] * k1)) % 2)  # checker
    rgb = np.stack([0.5 + 0.45 * a, 0.5 + 0.45 * b, 0.2 + 0.75 * c], 1)
    return np.clip(rgb, 0, 1)


def surface_gaussians(rng, n, kind, extent=2.0):
    if kind == "floor":
        p = np.stack([rng.uniform(-extent, extent, n),
                      np.full(n, -1.0),
                      rng.uniform(-extent, extent, n)], 1)
        s = np.stack([np.full(n, 0.035), np.full(n, 0.008),
                      np.full(n, 0.035)], 1)
        rgb = tex(p, 4.0, 6.0, 0.0)
    elif kind == "wall_z":
        p = np.stack([rng.uniform(-extent, extent, n),
                      rng.uniform(-1.0, 1.5, n),
                      np.full(n, extent)], 1)
        s = np.stack([np.full(n, 0.035), np.full(n, 0.035),
                      np.full(n, 0.008)], 1)
        rgb = tex(p, 5.0, 3.0, 1.0)
    elif kind == "wall_x":
        sgn = 1.0 if rng.random() > 0.5 else -1.0
        p = np.stack([np.full(n, sgn * extent),
                      rng.uniform(-1.0, 1.5, n),
                      rng.uniform(-extent, extent, n)], 1)
        s = np.stack([np.full(n, 0.008), np.full(n, 0.035),
                      np.full(n, 0.035)], 1)
        rgb = tex(p, 3.5, 5.5, 2.0)
    elif kind == "sphere":
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        p = v * 0.6 + np.array([0.0, 0.0, 0.3])
        s = np.full((n, 3), 0.02)
        rgb = tex(p * 3.0, 7.0, 9.0, 0.5)
    elif kind == "ring":
        t = rng.uniform(0, 2 * np.pi, n)
        u = rng.uniform(0, 2 * np.pi, n)
        R, r = 1.1, 0.12
        p = np.stack([(R + r * np.cos(u)) * np.cos(t),
                      0.35 + r * np.sin(u),
                      (R + r * np.cos(u)) * np.sin(t)], 1)
        s = np.full((n, 3), 0.018)
        rgb = tex(p * 4.0, 6.0, 4.0, 3.0)
    else:  # occluder blobs
        centers = rng.uniform(-1.2, 1.2, (12, 3)) * np.array([1, 0.6, 1])
        ci = rng.integers(0, 12, n)
        p = centers[ci] + rng.normal(size=(n, 3)) * 0.12
        s = np.full((n, 3), 0.05)
        rgb = tex(p * 2.0, 8.0, 8.0, 4.0)
    return p.astype(np.float32), s.astype(np.float32), rgb.astype(np.float32)


def orbit_camera(i, n, rng):
    """Camera-to-world pose on a jittered orbit; returns (q_wxyz, t) of the
    WORLD->CAM transform in COLMAP convention."""
    ang = 2 * np.pi * i / n + rng.normal() * 0.02
    height = 0.45 + 0.5 * np.sin(3 * ang) + rng.normal() * 0.05
    rad = 3.4 + rng.normal() * 0.1
    pos = np.array([rad * np.sin(ang), height, -rad * np.cos(ang)])
    look = np.array([0.0, 0.1, 0.3]) - pos
    look /= np.linalg.norm(look)
    up = np.array([0.0, -1.0, 0.0])   # colmap y-down
    right = np.cross(up, look)
    right /= np.linalg.norm(right)
    up2 = np.cross(look, right)
    Rcw = np.stack([right, up2, look], 1)       # cam->world (columns)
    Rwc = Rcw.T
    t = -Rwc @ pos
    # rotation matrix -> quaternion (wxyz)
    m = Rwc
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    else:
        i_ = np.argmax(np.diag(m))
        j, k = (i_ + 1) % 3, (i_ + 2) % 3
        s = math.sqrt(max(1.0 + m[i_, i_] - m[j, j] - m[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i_] = 0.25 * s
        q[1 + j] = (m[j, i_] + m[i_, j]) / s
        q[1 + k] = (m[k, i_] + m[i_, k]) / s
    return q / np.linalg.norm(q), t


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--cams", type=int, default=120)
    ap.add_argument("--gauss", type=int, default=80_000)
    ap.add_argument("--points", type=int, default=120_000)
    ap.add_argument("--budget", action=Refused, help="refused: " + NO_BUDGET)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--force_cpu", action="store_true",
                    help="render the ground truth on the CPU; without it the "
                         "script runs on the CUDA card or raises")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.force_cpu else None)

    rng = np.random.default_rng(args.seed)
    parts = [("floor", 0.22), ("wall_z", 0.14), ("wall_x", 0.14),
             ("sphere", 0.18), ("ring", 0.12), ("blobs", 0.20)]
    ps, ss, cs = [], [], []
    ops = []
    for kind, frac in parts:
        n = int(args.gauss * frac)
        p, s, rgb = surface_gaussians(rng, n, kind)
        ps.append(p); ss.append(s); cs.append(rgb)
        if kind == "blobs":
            ops.append(rng.uniform(0.25, 0.6, n).astype(np.float32))
        else:
            ops.append(rng.uniform(0.85, 1.0, n).astype(np.float32))
    means = np.concatenate(ps)
    scales = np.concatenate(ss) * (1.0 + 0.3 * rng.random((len(means), 1)))
    colors = np.concatenate(cs)
    opac = np.concatenate(ops)
    quats = rng.normal(size=(len(means), 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    G = len(means)
    print(f"GT gaussians: {G}")

    res = args.res
    fov = 1.05
    focal = res / (2 * math.tan(fov / 2))
    root = args.out
    sparse = os.path.join(root, "sparse/0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)

    cams = {1: colmap.ColmapCamera(1, "PINHOLE", res, res,
                                   np.array([focal, focal, res / 2, res / 2]))}
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))

    # the rasterizer's float32 inputs, as the JAX script's jnp.asarray
    tm, tsc, tq, tc, to = (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                           for x in (means, scales, quats, colors, opac))
    bg = torch.zeros(3, device=dev)
    images = {}
    for i in range(1, args.cams + 1):
        q, t = orbit_camera(i - 1, args.cams, rng)
        images[i] = colmap.ColmapImage(i, q, t, 1, f"im_{i:04d}.png")
        # the loaders' camera math (R = Rwc.T), as training reads it back
        cam = Camera(uid=i, colmap_id=i, R=qvec_to_rotmat(q).T, T=t,
                     fov_x=fov, fov_y=fov, image=None, width=res, height=res)
        with torch.no_grad():
            out = rasterize(tm, tsc, tq, tc, to,
                            world_view=torch.from_numpy(cam.world_view).to(dev),
                            full_proj=torch.from_numpy(cam.full_proj).to(dev),
                            tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                            width=res, height=res, bg=bg)
        img = np.clip(np.transpose(out.image.cpu().numpy(), (1, 2, 0)), 0, 1)
        write_png(os.path.join(root, "images", f"im_{i:04d}.png"),
                  (img * 255).astype(np.uint8))
        if i % 20 == 0:
            print(f"rendered {i}/{args.cams}")
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))

    sel = rng.choice(G, size=min(args.points, G), replace=False)
    xyz = means[sel] + rng.normal(size=(len(sel), 3)) * 0.005
    rgb = (colors[sel] * 255).astype(np.uint8)
    colmap.write_points3d_binary(xyz, rgb, os.path.join(sparse, "points3D.bin"))
    np.savez(os.path.join(root, "oracle.npz"), means=means, scales=scales,
             quats=quats, colors=colors, opac=opac)
    print(f"scene written to {root}: {args.cams} cams @ {res}^2, "
          f"{len(sel)} SfM points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
