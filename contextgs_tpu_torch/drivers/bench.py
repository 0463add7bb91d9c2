"""Rasterizer throughput (port of the JAX package's root `bench.py`):
forward+backward Mpix/s of `ops.rasterize.rasterize` (projection, tile
binning and depth sort, K1 and K2) on one 1280x720 frame of 200k gaussians,
seeded as `bench.py:62-69`.

    python -m contextgs_tpu_torch.drivers.bench [--force_cpu]

Each iteration takes the gradients of sum(image²) with respect to all five
inputs and feeds the means (plus 0·gradient) to the next, so the 30
iterations are chained; after `WARMUP` iterations they are timed with CUDA
events around the whole chain. Prints one JSON line with `bench.py`'s keys
and the card's name. On the CPU (only under `--force_cpu`) it runs a
64x64 frame of 500 gaussians, 2 iterations, timed by the host clock.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.ops.rasterize import rasterize
from contextgs_tpu_torch.scene.cameras import Camera

BASELINE_MPIX_S = 150.0       # bench.py's A100 reference envelope midpoint
WARMUP = 2
CARD = dict(width=1280, height=720, n_gauss=200_000, iters=30)
CPU = dict(width=64, height=64, n_gauss=500, iters=2)


def geometry(rng, n_gauss: int, scale_lo: float = 0.004,
             scale_hi: float = 0.02) -> tuple:
    """bench.py's first draws from `rng`, which the rasterizer scripts
    share: means, scales U(scale_lo, scale_hi) and unit quats, float32."""
    means = np.stack([rng.uniform(-3, 3, n_gauss), rng.uniform(-2, 2, n_gauss),
                      rng.uniform(2.0, 12.0, n_gauss)], 1).astype(np.float32)
    scales = rng.uniform(scale_lo, scale_hi, (n_gauss, 3)).astype(np.float32)
    quats = rng.normal(size=(n_gauss, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return means, scales, quats


def inputs(n_gauss: int, device, scale_lo: float = 0.004,
           scale_hi: float = 0.02) -> tuple:
    """bench.py's seeded gaussians: means, scales, quats, colors, opacities;
    the scales U(scale_lo, scale_hi)."""
    rng = np.random.default_rng(0)
    means, scales, quats = geometry(rng, n_gauss, scale_lo, scale_hi)
    colors = rng.uniform(0, 1, (n_gauss, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, n_gauss).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (means, scales, quats, colors, opac))


def camera_kwargs(width: int, height: int, device) -> dict:
    """`rasterize`'s camera arguments for bench.py's camera: identity pose,
    horizontal field of view 1.2 rad, black background."""
    cam = Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3), fov_x=1.2,
                 fov_y=2 * math.atan(math.tan(0.6) * height / width),
                 image=None, width=width, height=height)
    return dict(world_view=torch.from_numpy(cam.world_view).to(device),
                full_proj=torch.from_numpy(cam.full_proj).to(device),
                tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, width=width,
                height=height, bg=torch.zeros(3, device=device))


def step(means: torch.Tensor, rest, cam_kw: dict) -> torch.Tensor:
    """One forward+backward rasterization: the gradients of sum(image²)
    with respect to the means and `rest` (scales, quats, colors, opacities,
    each requiring grad); returns the means plus 0·gradient, so that the
    next step depends on this one."""
    m = means.detach().requires_grad_(True)
    out = rasterize(m, *rest, **cam_kw)
    grads = torch.autograd.grad((out.image * out.image).sum(), [m, *rest])
    return (m + 0.0 * grads[0]).detach()


def chain_seconds(means, rest, cam_kw: dict, iters: int, device,
                  warmup: int = WARMUP) -> float:
    """Seconds of `iters` chained `step`s after `warmup` untimed ones: by
    CUDA events around the whole chain on a CUDA device, by the host clock
    on the CPU."""
    for _ in range(warmup):
        means = step(means, rest, cam_kw)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            means = step(means, rest, cam_kw)
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        means = step(means, rest, cam_kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def measure(device, width: int, height: int, n_gauss: int,
            iters: int) -> dict:
    """Mpix/s of `iters` chained forward+backward rasterizations."""
    means, *rest = inputs(n_gauss, device)
    rest = [x.requires_grad_(True) for x in rest]
    seconds = chain_seconds(means, rest, camera_kwargs(width, height, device),
                            iters, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    mpix_s = iters * width * height / seconds / 1e6
    return {"metric": "rasterize_fwd_bwd_throughput",
            "value": round(mpix_s, 2), "unit": "Mpix/s/chip",
            "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 3),
            "device": name}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--force_cpu", action="store_true",
                   help="run the tiny CPU size; without it the bench runs on "
                        "the CUDA card or raises")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.force_cpu else None)
    print(json.dumps(measure(dev, **(CPU if args.force_cpu else CARD))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
