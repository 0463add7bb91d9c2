"""Sharded train-step scaling harness: pixels/s of the whole sharded
context-phase step per world size (port of the root
`scripts/scaling_bench.py`).

Each rank runs `parallel/sharded.make_sharded_train_step` on its slab:
the context and rate stage on its own anchors, the gather of the splat
state, its band of tile rows through K1 (K2 in the backward) by the
kernels' row offset, the summed gradients and Adam. One warm-up chain of
`--iters` steps, then `--iters` steps timed on the host's clock between
two synchronizes; pixels/s counts one camera ray a pixel.

    python -m contextgs_tpu_torch.scripts.scaling_bench \\
        [--size 64] [--points 1200] [--iters 8]          # every card, NCCL
    python -m contextgs_tpu_torch.scripts.scaling_bench --force_cpu 1,2,4

`--force_cpu N1,N2,...` runs N gloo ranks on the CPU for each N. They
share the host's cores, so that validates the sharded step end to end and
its ratios mean nothing. `--budget` is refused, as the drivers refuse it.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from contextgs_tpu_torch.config import (NO_BUDGET, ModelConfig,
                                        OptimizationConfig, PipelineConfig,
                                        TrainConfig)
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers import Refused
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.ops import rasterize
from contextgs_tpu_torch.ops.rasterize import tile_kernel
from contextgs_tpu_torch.parallel import comm
from contextgs_tpu_torch.parallel.sharded import (make_sharded_train_step,
                                                  shard_model)
from contextgs_tpu_torch.scene.cameras import Camera
from contextgs_tpu_torch.train.optim import init_adam

TIMEOUT_S = 900        # seconds the ranks may take
LEVEL_SCALES = (4.0, 16.0)
IT = 11000             # a step of the context phase


def config() -> TrainConfig:
    """The JAX script's model: small widths, every anchor rated."""
    return TrainConfig(
        model=ModelConfig(feat_dim=8, n_offsets=4, voxel_size=0.05,
                          level_num=3),
        opt=OptimizationConfig(rate_sample_frac=1.0),
        pipe=PipelineConfig(chunk_size=128))


def _keep_last_call(store: dict, name: str):
    """Wrap `rasterize.<name>` (K1's or K2's wrapper, looked up there at
    call time) in this rank's process so that the arguments of its last
    call stay in `store[name]`."""
    fn = getattr(rasterize, name)

    def call(*args):
        store[name] = args
        return fn(*args)

    setattr(rasterize, name, call)


def _bench_rank(mesh, job: dict) -> dict:
    """Rank body: the seeded model's slab, a warm-up chain, a timed chain.
    → pixels/s (rank 0's clock), the last loss, this rank's K1 and K2
    launches and steps; with `keep_kernel_args`, the last step's K1 and K2
    arguments on the host (`kernel_args`)."""
    cfg, size, iters = job["cfg"], job["size"], job["iters"]
    dev = mesh.device
    kept = {}
    if job["keep_kernel_args"]:
        _keep_last_call(kept, "blend_forward")
        _keep_last_call(kept, "blend_backward")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (job["points"], 3))
    model, voxel = st.init_scene_model(
        pts, cfg.model, generator=torch.Generator().manual_seed(0),
        device="cpu")
    sp, sb, sa = shard_model(mesh, model.params, model.buffers,
                             init_adam(model.params))
    cam = Camera(uid=0, colmap_id=0, R=np.eye(3),
                 T=np.array([0.0, 0.0, 2.5]), fov_x=1.0, fov_y=1.0,
                 image=None, width=size, height=size).as_device_dict()
    gt = torch.zeros((3, size, size), dtype=torch.float32, device=dev)
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    step = make_sharded_train_step(cfg, mesh, size, size, "context", 1.0,
                                   level_scales=LEVEL_SCALES,
                                   voxel_size=voxel)
    gen = torch.Generator(dev).manual_seed(mesh.rank)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mesh.barrier()

    def chain(sp, sb, sa):
        for _ in range(iters):
            sp, sb, sa, metrics = step(sp, sb, sa, cam, gt, bg, IT, True,
                                       gen)
        return sp, sb, sa, metrics

    sp, sb, sa, _ = chain(sp, sb, sa)
    sync()
    t0 = time.perf_counter()
    sp, sb, sa, metrics = chain(sp, sb, sa)
    sync()
    dt = time.perf_counter() - t0
    return dict(pix_s=iters * size * size / dt, seconds=dt,
                loss=float(metrics.loss), steps=2 * iters,
                k1_launches=tile_kernel.launches,
                k2_launches=tile_kernel.backward_launches,
                foreign_modules=comm.foreign_modules(),
                kernel_args={name: tuple(a.cpu() if torch.is_tensor(a)
                                         else a for a in args)
                             for name, args in kept.items()})


def measure(n_devices: int, size: int, points: int, iters: int, *,
            device=None, backend: str | None = None,
            keep_kernel_args: bool = False) -> dict:
    """The whole sharded context-phase step on `n_devices` ranks: one
    process a rank over NCCL on cards (default), or gloo (`backend`, or on
    the CPU). → rank 0's pixels/s and loss, and every rank's report
    (`ranks`), which with `keep_kernel_args` holds the arguments of the
    rank's last K1 and K2 calls, so that a caller can hold the kernels
    against their plain versions on this path's inputs. The kernels are
    built here, before the spawn."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        from contextgs_tpu_torch.ops import cuda_build
        cuda_build.build(tile_kernel.SOURCES)
    job = dict(cfg=config(), size=size, points=points, iters=iters,
               keep_kernel_args=keep_kernel_args)
    ranks = comm.spawn(_bench_rank, n_devices, (job,), backend=backend,
                       device_type=dev.type, timeout=TIMEOUT_S)
    return dict(pix_s=ranks[0]["pix_s"], loss=ranks[0]["loss"],
                ranks=ranks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--force_cpu", default=None,
                   help="comma list of CPU rank counts (gloo)")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--points", type=int, default=1200)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--budget", action=Refused, help="refused: " + NO_BUDGET)
    args = p.parse_args(argv)

    if args.force_cpu:
        for n in (int(x) for x in args.force_cpu.split(",")):
            res = measure(n, args.size, args.points, args.iters,
                          device="cpu")
            print(f"devices={n}: {res['pix_s'] / 1e3:8.1f} kpix/s (CPU "
                  "ranks over gloo: execution validated; ratios not "
                  f"meaningful) loss={res['loss']:.6f}", flush=True)
    else:
        n = torch.cuda.device_count()
        res = measure(n, args.size, args.points, args.iters)
        print(f"devices={n} (cuda): {res['pix_s'] / 1e6:.3f} Mpix/s "
              f"full-train-step loss={res['loss']:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
