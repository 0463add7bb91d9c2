"""Training driver (port of the JAX package's root `train.py`): train →
estimate → encode → decode → render the test split from the DECODED scene →
metrics → results.json.

    python -m contextgs_tpu_torch.drivers.train -s <scene_dir> -m outputs/scene \
        --lmbda 0.001 [--preset mipnerf360] [--gui --ip 127.0.0.1 --port 6009] \
        [--force_cpu]

The flags are the JAX driver's. Refused, with the reason: `--budget` and
`--train_vis_cap` (the port sizes its instance lists per render) and a
`--backend` other than `auto` (the rasterizer follows the tensors' device).
`--gui` serves live renders to a SIBR remote viewer on `--ip`:`--port`
(`utils/viewer.py`; `viewer_render` draws each frame through K1 in the
phase training is in). `--profile_steps` writes a `torch.profiler` trace
under `<model_path>/profile` and, beside it, `spans.json`: the program's
spans (`utils/trace.py`) by name, each with its count, ms and self ms a
step, and its counters a step; `--detect_anomaly` turns on
`torch.autograd.set_detect_anomaly`.

`--mesh N` trains on N ranks (`train/sharded_loop.train_sharded`): one
process a CUDA card over NCCL, and more ranks than cards raise;
`--mesh_force_cpu` (or `--force_cpu`) runs the N ranks on the CPU over
gloo, the counterpart of the JAX driver's virtual CPU mesh. Rank 0 writes
the logs, the checkpoints and the snapshot; this process then encodes,
decodes, renders and writes results.json from the gathered model, as after
a single-process run. `--detect_anomaly` turns anomaly mode on in every
rank. As in the JAX driver, a mesh run neither profiles (`--profile_steps`
is refused with `--mesh`) nor polls the viewer: `--gui` with `--mesh`
opens the server and renders nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from contextgs_tpu_torch import drivers
from contextgs_tpu_torch import evaluation as ev
from contextgs_tpu_torch.compression.codec import decode_scene, encode_scene
from contextgs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                        PipelineConfig, TrainConfig, preset)
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.levels import build_level_maps
from contextgs_tpu_torch.models.renderer import render
from contextgs_tpu_torch.scene.ply_io import read_ply
from contextgs_tpu_torch.train.loop import TrainerState, phase_of, train
from contextgs_tpu_torch.train.sharded_loop import train_sharded
from contextgs_tpu_torch.utils import trace
from contextgs_tpu_torch.utils.tboard import SummaryWriter
from contextgs_tpu_torch.utils.viewer import ViewerServer

MB = 8 * 1024 * 1024


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", default="")
    p.add_argument("--images", default="images")
    p.add_argument("-r", "--resolution", type=int, default=-1)
    p.add_argument("--preset", default=None,
                   choices=["mipnerf360", "tandt", "deep_blending",
                            "nerf_synthetic", "bungeenerf"])
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--lod", type=int, default=0)
    p.add_argument("--voxel_size", type=float, default=None)
    p.add_argument("--update_init_factor", type=int, default=None)
    p.add_argument("--iterations", type=int, default=30_000)
    # schedule boundaries (defaults = reference values; override to scale
    # down for smoke runs)
    p.add_argument("--noise_from", type=int, default=3000)
    p.add_argument("--context_from", type=int, default=10_000)
    p.add_argument("--start_stat", type=int, default=500)
    p.add_argument("--update_from", type=int, default=1500)
    p.add_argument("--update_interval", type=int, default=100)
    p.add_argument("--update_until", type=int, default=15_000)
    p.add_argument("--lmbda", type=float, default=0.001)
    p.add_argument("--lmbda_rec", type=float, default=1.0)
    p.add_argument("--level_num", type=int, default=3)
    p.add_argument("--disable_hyper", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--start_checkpoint", default=None,
                   help="resume from a training checkpoint of either "
                        "package (chkpnt{it}.pt, or the JAX package's "
                        "chkpnt{it}.pkl)")
    p.add_argument("--train_vis_cap", action=drivers.Refused,
                   help="refused: the port renders every visible gaussian "
                        "of a training view, it has no visible cap")
    p.add_argument("--n_offsets", type=int, default=None,
                   help="gaussians decoded per anchor (ref n_offsets=10)")
    p.add_argument("--anchor_capacity", type=int, default=0,
                   help="initial padded anchor-pool capacity (0 = "
                        "capacity_headroom x initial anchors); the pool "
                        "doubles when densification fills it")
    p.add_argument("--backend", default="auto",
                   help="refused unless 'auto': the rasterizer runs K1 and "
                        "K2 on CUDA tensors and their plain versions on CPU "
                        "tensors")
    p.add_argument("--skip_codec", action="store_true")
    p.add_argument("--skip_render", action="store_true")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--no_tensorboard", action="store_true",
                   help="disable TensorBoard event files under <model_path>/tb")
    # the live SIBR remote-viewer server
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--gui", action="store_true",
                   help="serve live renders to a SIBR remote viewer")
    p.add_argument("--test_iterations", nargs="+", type=int, default=None,
                   help="iterations at which to evaluate the test split "
                        "mid-training (default: final iteration)")
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=None,
                   help="iterations at which to write a resumable training "
                        "checkpoint, chkpnt{it}.pt under model_path")
    p.add_argument("--warmup", action="store_true",
                   help="after training, reboot a second run initialized from "
                        "the saved PLY snapshot (ref train.py:669-672)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace N steps with torch.profiler (a Chrome trace "
                        "under <model_path>/profile)")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd.set_detect_anomaly over training")
    p.add_argument("--mesh", type=int, default=None,
                   help="train on N ranks, one a CUDA card over NCCL "
                        "(anchors sharded, image tiles banded; "
                        "parallel/sharded.py); the final encode runs from "
                        "the gathered model")
    p.add_argument("--mesh_force_cpu", action="store_true",
                   help="run the --mesh ranks on the CPU over gloo")
    drivers.add_common(p)
    return p


def refuse(p: argparse.ArgumentParser, args) -> None:
    """Exit with a message for a flag the port has no meaning for, or for
    one given without the flag it needs (`--budget` and `--train_vis_cap`
    fail the parse itself: `drivers.Refused`)."""
    if args.backend != "auto":
        p.error("--backend is refused: the rasterizer runs K1 and K2 on CUDA "
                "tensors and their plain versions on CPU tensors")
    if args.mesh_force_cpu and not args.mesh:
        p.error("--mesh_force_cpu is refused without --mesh N")
    if args.mesh is not None and args.mesh < 1:
        p.error("--mesh needs a number of ranks >= 1")
    if args.mesh and args.profile_steps:
        p.error("--profile_steps is refused with --mesh: the ranks train in "
                "processes of their own, and the JAX driver's mesh run "
                "profiles nothing either")


def config_from_args(args) -> TrainConfig:
    if args.preset:
        model = preset(args.preset, level_num=args.level_num,
                       lod=args.lod or preset(args.preset).lod)
    else:
        model = ModelConfig(level_num=args.level_num, lod=args.lod,
                            white_background=args.white_background)
    overrides = {}
    if args.voxel_size is not None:
        overrides["voxel_size"] = args.voxel_size
    if args.update_init_factor is not None:
        overrides["update_init_factor"] = args.update_init_factor
    if args.white_background:
        overrides["white_background"] = True
    if args.anchor_capacity:
        overrides["anchor_capacity"] = args.anchor_capacity
    if args.n_offsets is not None:
        overrides["n_offsets"] = args.n_offsets
    overrides["resolution"] = args.resolution
    model = dataclasses.replace(model, **overrides)
    opt = OptimizationConfig(iterations=args.iterations, lmbda=args.lmbda,
                             lmbda_rec=args.lmbda_rec,
                             disable_hyper=args.disable_hyper,
                             noise_from=args.noise_from,
                             context_from=args.context_from,
                             start_stat=args.start_stat,
                             update_from=args.update_from,
                             update_interval=args.update_interval,
                             update_until=args.update_until)
    return TrainConfig(model=model, opt=opt,
                       pipe=PipelineConfig(backend=args.backend),
                       source_path=os.path.abspath(args.source_path),
                       model_path=args.model_path, images=args.images,
                       seed=args.seed, start_checkpoint=args.start_checkpoint,
                       save_iterations=(args.iterations,),
                       checkpoint_iterations=tuple(
                           args.checkpoint_iterations or ()),
                       test_iterations=tuple(args.test_iterations
                                             or (args.iterations,)))


def profiler(cfg: TrainConfig, n: int, dev: torch.device, log):
    """A torch.profiler over steps [start, start + n) of a run, stepped from
    the training callback and written as a Chrome trace under
    `<model_path>/profile`, with the program's spans of those steps
    summarised in `spans.json` beside it; a null context without `n` or a
    model_path."""
    if not n or not cfg.model_path:
        return contextlib.nullcontext()
    start = 20 if cfg.opt.iterations > 25 else 1
    if start + n > cfg.opt.iterations:
        log.warning("--profile_steps window [%d, %d) extends past the %d "
                    "iterations; the trace will be closed at training end",
                    start, start + n, cfg.opt.iterations)
    path = os.path.join(cfg.model_path, "profile", "trace.json")

    def write(prof):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(os.path.join(os.path.dirname(path), "spans.json"),
                  "w") as f:
            json.dump(trace.summary(trace.take(), "train/step"), f, indent=1)
        log.info("profiler trace written to %s", path)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, on_trace_ready=write,
        schedule=torch.profiler.schedule(wait=start - 1, warmup=1, active=n,
                                         repeat=1))


@torch.no_grad()
def viewer_render(ts: TrainerState, it: int, cfg: TrainConfig, cam,
                  scaling_modifier: float = 1.0) -> torch.Tensor:
    """One live-viewer frame of the model training is at: [H, W, 3] in
    [0, 1] on the model's device, rendered through K1 by
    `models/renderer.render(training=False)` in the phase of step `it`
    (the noise phase while the level scales are not searched yet; in the
    context phase over the level maps of the quantized anchors), with the
    wire's scaling modifier and a generator seeded 0. `cam` is a `MiniCam`
    (or a `Camera`)."""
    phase = phase_of(it, cfg)
    scales = tuple(ts.level_scales or ())
    if phase == "context" and not scales:
        phase = "noise"    # scales not searched yet this step
    p, b = ts.model.params, ts.model.buffers
    dev = p.anchor.device
    maps = None
    if phase == "context":
        maps = build_level_maps(st.get_anchor(p, b), b.alive, ts.voxel_size,
                                scales, cfg.model.level_num)
    out = render(p, b, cfg.model, cfg.opt, cfg.pipe, cam.as_device_dict(),
                 cam.width, cam.height,
                 torch.from_numpy(drivers.background(cfg)),
                 torch.Generator(dev).manual_seed(0), phase=phase,
                 training=False, maps=maps,
                 scale_modifier=float(scaling_modifier))
    return out.image.clamp(0.0, 1.0).permute(1, 2, 0)


def open_viewer(args, log):
    """The `--gui` server as a context that closes it, else a null one."""
    if not args.gui:
        return contextlib.nullcontext()
    viewer = ViewerServer(args.ip, args.port)
    log.info("viewer listening on %s:%d", viewer.host, viewer.port)
    return contextlib.closing(viewer)


def write_progress(model_path: str, total: int, it: int, ts, metrics) -> None:
    """Heartbeat for external monitors, every 100 steps: a killed run
    leaves its last known state on disk. A training callback (with
    model_path and total bound), picklable for the ranks of `--mesh`."""
    if not model_path or it % 100:
        return
    tmp = os.path.join(model_path, ".progress.json.tmp")
    with open(tmp, "w") as f:
        json.dump(dict(iteration=it, loss=float(metrics.loss),
                       psnr=float(metrics.psnr),
                       bpp=float(metrics.bit_per_param), total=total,
                       ts=time.time()), f)
    os.replace(tmp, os.path.join(model_path, "progress.json"))


def run_training(args, cfg: TrainConfig, scene, dev: torch.device, callback,
                 tb):
    """train(), or with --mesh N train_sharded() on N ranks (rank 0 writes
    the heartbeat; the training scalars go to TensorBoard afterwards, from
    rank 0's report)."""
    if not args.mesh:
        return train(cfg, scene, device=dev, callback=callback)
    ts = train_sharded(
        cfg, scene, args.mesh, device=dev,
        callback=functools.partial(write_progress, cfg.model_path,
                                   cfg.opt.iterations),
        detect_anomaly=args.detect_anomaly)
    if tb is not None:
        for s in ts.ranks[0]["steps"]:
            if s["it"] % 100 == 0:
                tb.add_scalar("train_loss_patches/total_loss", s["loss"],
                              s["it"])
                tb.add_scalar("train/psnr", s["psnr"], s["it"])
                tb.add_scalar("train/bit_per_param", s["bit_per_param"],
                              s["it"])
    return ts


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    refuse(p, args)
    if args.mesh_force_cpu:
        args.force_cpu = True
    dev = drivers.check_common(p, args)
    cfg = config_from_args(args)
    with drivers.logging_to(cfg.model_path) as log:
        return _run(args, cfg, dev, log)


def _run(args, cfg: TrainConfig, dev: torch.device, log) -> int:
    if cfg.model_path:
        with open(os.path.join(cfg.model_path, "cfg_args"), "w") as f:
            f.write(cfg.to_json())

    log.info("loading scene %s", cfg.source_path)
    scene = drivers.scene_of(cfg, cfg.source_path)
    log.info("scene: %d train / %d test cameras, %d points",
             len(scene.train_cameras), len(scene.test_cameras),
             len(scene.points))

    tb = None
    if cfg.model_path and not args.no_tensorboard:
        tb = SummaryWriter(os.path.join(cfg.model_path, "tb"))
    prof = None     # the profiler, while the first run trains
    viewer = None   # the --gui server, while training

    def callback(it, ts_, metrics):
        write_progress(cfg.model_path, cfg.opt.iterations, it, ts_, metrics)
        if prof is not None:
            prof.step()
        if viewer is not None:
            viewer.poll(lambda cam, smod: viewer_render(
                ts_, it, cfg, cam, smod).cpu().numpy(), cfg.source_path, it,
                cfg.opt.iterations)
        if tb is not None and it % 100 == 0:
            tb.add_scalar("train_loss_patches/total_loss",
                          float(metrics.loss), it)
            tb.add_scalar("train/psnr", float(metrics.psnr), it)
            tb.add_scalar("train/bit_per_param",
                          float(metrics.bit_per_param), it)
            tb.add_scalar("total_points", st.n_alive(ts_.model), it)

    try:
        with torch.autograd.set_detect_anomaly(args.detect_anomaly), \
                open_viewer(args, log) as viewer:
            # a trace whose window runs past training closes at its end
            with profiler(cfg, args.profile_steps, dev, log) as prof:
                ts = run_training(args, cfg, scene, dev, callback, tb)
            prof = None
            if args.warmup:
                # reboot from the just-saved PLY snapshot: its anchors
                # become the initial point cloud of a fresh run (ref
                # train.py:669-672)
                log.info("warmup finished — rebooting from last PLY "
                         "snapshot")
                v = read_ply(os.path.join(
                    cfg.model_path, "point_cloud",
                    f"iteration_{cfg.opt.iterations}", "point_cloud.ply"))
                scene = dataclasses.replace(
                    scene, points=np.stack([v["x"], v["y"], v["z"]], axis=1))
                ts = run_training(args, cfg, scene, dev, callback, tb)

        if args.skip_codec:
            return 0

        # encode → decode → evaluate from the decoded scene (ref
        # train.py:298-314)
        out_dir = os.path.join(cfg.model_path or ".", "bitstreams")
        bits = encode_scene(ts.model.params, ts.model.buffers, cfg.model,
                            ts.level_scales or [], ts.voxel_size, out_dir,
                            disable_hyper=cfg.opt.disable_hyper)
        log.info("encoded: %.3f MB total (feat %.3f, scaling %.3f, offsets "
                 "%.3f, hyper %.3f, anchor %.3f, masks %.3f, mlp %.3f) in "
                 "%.1fs", bits["total"] / MB, bits["feat"] / MB,
                 bits["scaling"] / MB, bits["offsets"] / MB,
                 bits["hyper"] / MB, bits["anchor"] / MB, bits["masks"] / MB,
                 bits["mlp"] / MB, bits["time_s"])
        dec = decode_scene(out_dir, cfg.model, device=dev)
        if args.skip_render or not scene.test_cameras:
            return 0
        cam0 = scene.test_cameras[0]
        renderer = ev.make_decoded_renderer(dec, cfg, cam0.width,
                                            cam0.height, device=dev)
        renders, gts, fps = ev.render_set(
            renderer, scene.test_cameras, drivers.background(cfg),
            out_dir=os.path.join(cfg.model_path or ".", "test"),
            save_images=args.save_images)
        metrics = ev.evaluate_images(renders, gts, device=dev)
        log.info("test: PSNR %.3f SSIM %.4f FPS %.1f", metrics["PSNR"],
                 metrics["SSIM"], fps)
        if tb is not None:
            it = cfg.opt.iterations
            tb.add_scalar("test/PSNR", metrics["PSNR"], it)
            tb.add_scalar("test/SSIM", metrics["SSIM"], it)
            # the first decoded test render and its target, [H,W,3]
            tb.add_image("test/render", np.transpose(
                renders[0].cpu().numpy(), (1, 2, 0)), it)
            tb.add_image("test/ground_truth",
                         np.transpose(gts[0], (1, 2, 0)), it)
        ev.write_results(cfg.model_path or ".", "ours", metrics, bits, fps)
        return 0
    finally:
        if tb is not None:
            tb.close()


if __name__ == "__main__":
    sys.exit(main())
