"""Stage-by-stage profile of `ops.rasterize.rasterize` and its backward on
the bench frame (port of the root `scripts/profile.py`).

The frame is `drivers.bench`'s: 200k seeded gaussians at 1280x720 by
default (`scripts/profile.py:78-90`). First the end-to-end number: `iters`
chained forward+backward steps, `drivers.bench.step` itself, timed as the
bench times them (`drivers.bench.chain_seconds`). Then each stage as
`rasterize()` and its backward consume it, in call order:

    projection fwd    ops.rasterize.project_gaussians (with opacities)
    expand_and_sort   the tile binning and the two stable sorts
    splat_rows        the [G,9] row table (the counterpart of `_pack`'s
                      row gathers: K1 gathers the rows by gauss_ids itself)
    blend fwd (K1)    tile_kernel.blend_forward
    blend bwd (K2)    tile_kernel.blend_backward, cotangents of ones
    projection vjp    torch.autograd.grad of means2d with respect to the
                      means, scales and quats (forward included), as the
                      JAX script's `jax.vjp` of means2d

The JAX script's "bwd segment reduce" has no counterpart: K2 sums each
instance's gradient into d_rows with atomics, so no row is printed for it.

Each stage is timed by `scripts.time_ms` (CUDA events around `iters`
back-to-back calls, the host's launch gaps included) and, on the card, by
the profiler's kernel time (`scripts.device_profile`): a stage whose events
time is well above its device time is bound by the host. `expand_and_sort`
reads the instance count back to the host, so its events include a sync.
On the CPU (`--force_cpu` or `device="cpu"`) the host clock times the stages
and the device time is not measured.

    python -m contextgs_tpu_torch.scripts.profile [--gauss 200000]
        [--width 1280] [--height 720] [--iters 10] [--e2e-only] [--force_cpu]

`--budget` and `--chunk`, the JAX script's instance budget and Pallas
chunk, are refused: the port's tile lists are sized per render and its
kernels take each tile's list whole.
"""

from __future__ import annotations

import argparse
import sys

import torch

from contextgs_tpu_torch.config import NO_BUDGET, NO_CHUNK
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers import Refused, bench
from contextgs_tpu_torch.ops import rasterize as rz
from contextgs_tpu_torch.ops.rasterize import TILE
from contextgs_tpu_torch.scripts import device_profile, time_ms

STAGES = ("projection fwd", "expand_and_sort", "splat_rows", "blend fwd (K1)",
          "blend bwd (K2)", "projection vjp")


def stage_calls(means, scales, quats, colors, opac, cam_kw: dict) -> dict:
    """{stage: a call of it on this frame}, each on the outputs of the
    stages before it, computed once here."""
    w, h = cam_kw["width"], cam_kw["height"]
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    geom = (cam_kw["world_view"], cam_kw["full_proj"], cam_kw["tanfovx"],
            cam_kw["tanfovy"], w, h, TILE)

    def project(m, s, q):
        return rz.project_gaussians(m, s, q, *geom, opacities=opac)

    proj = project(means, scales, quats)
    inst = rz.expand_and_sort(proj, tiles_x, tiles_y)
    rows = rz.splat_rows(proj, colors, opac)
    lists = (rows, inst.gauss_ids, inst.tile_bounds)
    fwd = rz.blend_forward(*lists, w, h)
    ones = (torch.ones_like(fwd[0]), torch.ones_like(fwd[1]))
    leaves = [x.detach().requires_grad_(True) for x in (means, scales, quats)]

    def vjp():
        with torch.enable_grad():
            m2 = project(*leaves).means2d
            return torch.autograd.grad(m2, leaves, torch.ones_like(m2),
                                       allow_unused=True)

    calls = dict(zip(STAGES, (
        lambda: project(means, scales, quats),
        lambda: rz.expand_and_sort(proj, tiles_x, tiles_y),
        lambda: rz.splat_rows(proj, colors, opac),
        lambda: rz.blend_forward(*lists, w, h),
        lambda: rz.blend_backward(*lists, *fwd, *ones, w, h),
        vjp)))
    counts = dict(instances=inst.demand, visible=int(inst.n_vis),
                  tiles=tiles_x * tiles_y,
                  occupied_tiles=int((inst.tile_bounds.diff() > 0).sum()))
    return calls, counts


def measure(device=None, gauss: int = 200_000, width: int = 1280,
            height: int = 720, iters: int = 10, e2e_only: bool = False,
            scale_lo: float = 0.004, scale_hi: float = 0.02) -> dict:
    """The end-to-end ms and Mpix/s and, unless `e2e_only`, each stage's ms
    (events) and device ms (None where not measured), their totals and the
    frame's counts. K1 and K2 each run `bench.WARMUP + iters` times end to
    end, and `iters + 1` times a stage timing (twice that on the card,
    where the profiler times them again); K1 once more for K2's inputs."""
    dev = resolve_device(device)
    means, *rest = bench.inputs(gauss, dev, scale_lo, scale_hi)
    cam_kw = bench.camera_kwargs(width, height, dev)
    grads = [x.detach().requires_grad_(True) for x in rest]
    seconds = bench.chain_seconds(means, grads, cam_kw, iters, dev)
    out = dict(device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
               gaussians=gauss, width=width, height=height, iters=iters,
               e2e_ms=seconds / iters * 1e3,
               mpix_s=iters * width * height / seconds / 1e6)
    if e2e_only:
        return out
    with torch.no_grad():
        calls, counts = stage_calls(means, *rest, cam_kw)
        stages = {}
        for name, fn in calls.items():
            stages[name] = dict(
                ms=time_ms(fn, dev, iters),
                device_ms=(device_profile(fn, iters)[0]
                           if dev.type == "cuda" else None))
    out.update(stages=stages, **counts,
               total_ms=sum(s["ms"] for s in stages.values()),
               total_device_ms=(sum(s["device_ms"] for s in stages.values())
                                if dev.type == "cuda" else None))
    return out


def report(res: dict) -> None:
    """The JAX script's lines: E2E, one line a stage, the total, the
    counts; the device ms beside the events."""
    def dev_ms(x):
        return "not measured" if x is None else f"{x:8.3f} ms"

    print(f"profile on {res['device']}: {res['gaussians']} gaussians, "
          f"{res['width']}x{res['height']}, {res['iters']} iterations")
    print(f"{'E2E fwd+bwd':28s} {res['e2e_ms']:8.2f} ms   = "
          f"{res['mpix_s']:.1f} Mpix/s")
    if "stages" not in res:
        return
    for name, s in res["stages"].items():
        print(f"{name:28s} {s['ms']:8.2f} ms   device {dev_ms(s['device_ms'])}")
    print(f"{'TOTAL (stages)':28s} {res['total_ms']:8.2f} ms   device "
          f"{dev_ms(res['total_device_ms'])}")
    print(f"instances: {res['instances']}  visible gaussians: "
          f"{res['visible']}  tiles: {res['tiles']}  occupied tiles: "
          f"{res['occupied_tiles']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gauss", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--scale-lo", type=float, default=0.004)
    ap.add_argument("--scale-hi", type=float, default=0.02)
    ap.add_argument("--e2e-only", action="store_true")
    ap.add_argument("--budget", action=Refused, help="refused: " + NO_BUDGET)
    ap.add_argument("--chunk", action=Refused, help="refused: " + NO_CHUNK)
    ap.add_argument("--force_cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                         "without it the profile runs on the CUDA card or "
                         "raises")
    args = ap.parse_args(argv)
    report(measure("cpu" if args.force_cpu else None, args.gauss, args.width,
                   args.height, args.iters, args.e2e_only, args.scale_lo,
                   args.scale_hi))
    return 0


if __name__ == "__main__":
    sys.exit(main())
