"""Decoded-scene rendering FPS at 1280x720 (port of the root
`scripts/fps_bench.py`): the per-view loop against a chained one.

The scene is the JAX script's synthetic decoded scene
(`scripts/fps_bench.py:55-63`, `decoded_scene`): 100k anchors uniform in
[-2, 2]³ at `ModelConfig` widths (feat_dim 50, 10 offsets), scaling U(0.01,
0.05), 70% of the offsets kept, the arrays drawn from numpy's seeded
generator in the JAX script's order and the decoder MLPs from torch's. V
cameras orbit it at radius 4 (`orbit`). The renderer is
`evaluation.make_decoded_renderer`; after one warm-up view:

  a) naive: `render_set`'s protocol, one pair of CUDA events around each
     view and a sync after it, the camera handed over as numpy;
  b) chained: the camera tensors put on the card first, then all V views
     enqueued back to back with the mean of each image added up on the
     card (as the JAX script's `render_all`, `:96-107`), one pair of
     events around the whole loop and one sync at its end.

The chained path amortizes less than the JAX script's: that one runs the V
views as one `fori_loop` inside one jit, whereas the port's renderer
synchronizes with the host twice a view — the visible anchors are
compacted by `torch.nonzero` (`evaluation.py:63`), and the tile binning
reads the instance count back (`ops/rasterize/sorting.py`, `sort.demand`)
— so the host still waits for the card in every view, and what (b) saves
is the per-view event sync and the cameras' copies.

Prints both ms a view, both FPS and their ratio. On the CPU (`--force_cpu`,
or `device="cpu"`) the host clock stands in for the events.

    python -m contextgs_tpu_torch.scripts.fps_bench [--anchors 100000]
        [--views 32] [--width 1280] [--height 720] [--force_cpu]

`--budget` is refused: the port's tile lists are sized per render.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from contextgs_tpu_torch.compression.codec import DecodedScene
from contextgs_tpu_torch.config import (NO_BUDGET, ModelConfig,
                                        PipelineConfig, TrainConfig)
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers import Refused
from contextgs_tpu_torch.evaluation import make_decoded_renderer
from contextgs_tpu_torch.models.mlps import init_decoder_mlps
from contextgs_tpu_torch.models.renderer import camera_tensors
from contextgs_tpu_torch.scene.cameras import Camera


def decoded_scene(n_anchors: int, seed: int, cfg: ModelConfig,
                  device) -> DecodedScene:
    """The JAX script's decoded scene (`scripts/fps_bench.py:55-63`), its
    arrays drawn from `np.random.default_rng(seed)` in that order and
    rounded to float32 where it rounds them, its MLPs from
    `torch.Generator().manual_seed(seed)`."""
    rng = np.random.default_rng(seed)
    n, f, k = n_anchors, cfg.feat_dim, cfg.n_offsets

    def put(x):
        return torch.from_numpy(x).to(device)

    f32 = np.float32
    return DecodedScene(
        anchor=put(rng.uniform(-2, 2, (n, 3)).astype(f32)),
        feat=put(rng.normal(size=(n, f)).astype(f32) * 0.3),
        scaling=put(rng.uniform(0.01, 0.05, (n, 6)).astype(f32)),
        offsets=put(rng.normal(size=(n, k, 3)).astype(f32) * 0.3),
        masks=put((rng.random((n, k)) < 0.7).astype(f32)),
        hyper=put(np.zeros((n, f // cfg.hyper_divisor), f32)),
        mlps=init_decoder_mlps(cfg, torch.Generator().manual_seed(seed),
                               device),
        prior=None, level_scales=[], voxel_size=0.001)


def orbit(views: int, width: int, height: int) -> list:
    """The JAX script's cameras: `views` evenly spaced about the y axis at
    distance 4, horizontal field of view 1.2 rad, no image."""
    cams = []
    for i in range(views):
        ang = 2 * np.pi * i / views
        rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]])
        cams.append(Camera(uid=i, colmap_id=i, R=rot,
                           T=np.array([0.0, 0.0, 4.0]), fov_x=1.2,
                           fov_y=2 * math.atan(math.tan(0.6) * height / width),
                           image=None, width=width, height=height))
    return cams


def _clock(device):
    """(start, stop) of a timing: CUDA events on a CUDA device, the host
    clock on the CPU; stop() syncs and returns the ms since start()."""
    if device.type != "cuda":
        t0 = []
        return (lambda: t0.append(time.perf_counter()),
                lambda: (time.perf_counter() - t0.pop()) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def stop():
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return start.record, stop


def naive(render, cams, bg, images: list | None = None):
    """(a): each view timed alone, the camera as numpy; → (ms of each view,
    the sum of the images' means on the device). The images are appended
    to `images` when it is given."""
    start, stop = _clock(render.device)
    ms, acc = [], torch.zeros((), device=render.device)
    for cam in cams:
        start()
        img = render(cam.as_device_dict(), bg)
        ms.append(stop())
        acc = acc + img.mean()
        if images is not None:
            images.append(img)
    return ms, acc


def chained(render, cams, bg, images: list | None = None):
    """(b): the camera tensors on the device first, then every view back to
    back, the images' means added up on the device; → (ms of the whole
    loop, that sum)."""
    dev = render.device
    cams = [camera_tensors(c.as_device_dict(), dev) for c in cams]
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    start, stop = _clock(dev)
    acc = torch.zeros((), device=dev)
    start()
    for cam in cams:
        img = render(cam, bg)
        acc = acc + img.mean()
        if images is not None:
            images.append(img)
    return stop(), acc


def measure(anchors: int = 100_000, views: int = 32, width: int = 1280,
            height: int = 720, device=None, feat_dim: int = 50,
            n_offsets: int = 10) -> dict:
    """ms a view of (a) and (b), their FPS and ratio, and each path's sum
    of the images' means. K1 runs 1 + 2·views times."""
    dev = resolve_device(device)
    mcfg = ModelConfig(feat_dim=feat_dim, n_offsets=n_offsets)
    cfg = TrainConfig(model=mcfg, pipe=PipelineConfig(chunk_size=128))
    render = make_decoded_renderer(decoded_scene(anchors, 0, mcfg, dev),
                                   cfg, width, height, dev)
    cams = orbit(views, width, height)
    bg = np.zeros(3, np.float32)
    render(cams[0].as_device_dict(), bg)
    ms, naive_sum = naive(render, cams, bg)
    chain_ms, chain_sum = chained(render, cams, bg)
    naive_view, chain_view = sum(ms) / views, chain_ms / views
    return dict(device=(torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
                anchors=anchors, views=views, width=width, height=height,
                naive_ms=naive_view, chained_ms=chain_view,
                naive_fps=1e3 / naive_view, chained_fps=1e3 / chain_view,
                ratio=naive_view / chain_view,
                naive_sum=float(naive_sum), chained_sum=float(chain_sum))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--anchors", type=int, default=100_000)
    ap.add_argument("--views", type=int, default=32)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--feat-dim", type=int, default=50)
    ap.add_argument("--n-offsets", type=int, default=10)
    ap.add_argument("--budget", action=Refused, help="refused: " + NO_BUDGET)
    ap.add_argument("--force_cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                         "without it the bench runs on the CUDA card or "
                         "raises")
    args = ap.parse_args(argv)
    r = measure(args.anchors, args.views, args.width, args.height,
                "cpu" if args.force_cpu else None, args.feat_dim,
                args.n_offsets)
    where = (f"@ {r['width']}x{r['height']}, {r['anchors']} anchors, "
             f"{r['device']}")
    print(f"naive per-view loop:  {r['naive_ms']:8.2f} ms/view "
          f"= {r['naive_fps']:6.1f} FPS {where}")
    print(f"chained views:        {r['chained_ms']:8.2f} ms/view "
          f"= {r['chained_fps']:6.1f} FPS {where}")
    print(f"naive / chained: {r['ratio']:.2f}x; sums of the images' means "
          f"{r['naive_sum']:.6f} / {r['chained_sum']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
