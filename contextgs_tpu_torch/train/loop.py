"""Host-side training orchestration (port of `contextgs_tpu/train/loop.py`).

`run_schedule` is the schedule of a run, for `train` here and for
`train/sharded_loop.train_sharded`: random camera order from a numpy
Generator, the per-phase schedule (plain, noise, context), the anchor-bound
refresh and the level-scale search at the context transition
(`context_transition`), densification every `update_interval` steps inside
(update_from, update_until) except in [3000, 4000), logging, checkpoints
(`save_state`). A `Run` does each event on its state; this module's, on one
device, also grows the pool when densification runs out of free slots,
evaluates at `test_iterations` and logs the model's size estimate every
2000 context steps. `start_state` builds a run's state from the scene's
points, or resumes from a checkpoint of either loop or of the JAX package.

The reference's static-shape machinery — the instance budget, `vis_cap` and
their watermark adaptation — has no counterpart: the port's shapes are
dynamic. A checkpoint or save iteration with a `model_path` writes the
training checkpoint `chkpnt{it}.pt`; a save iteration also writes the model
snapshot `point_cloud/iteration_{it}/{point_cloud.ply, checkpoint.pth}`.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from contextgs_tpu_torch.config import TrainConfig
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.models import densify, state as st
from contextgs_tpu_torch.models.context import estimate_total_bits
from contextgs_tpu_torch.models.levels import find_divide_scale
from contextgs_tpu_torch.models.mlps import count_mlp_params
from contextgs_tpu_torch.models.state import Buffers, Params, SceneModel
from contextgs_tpu_torch.ops.ssim import psnr as psnr_fn
from contextgs_tpu_torch.scene.dataset_readers import SceneInfo
from contextgs_tpu_torch.scene.snapshot import save_model_ply, save_networks
from contextgs_tpu_torch.train.optim import AdamState, init_adam
from contextgs_tpu_torch.train.step import (kept_level_maps, make_eval_render,
                                            make_train_step)
from contextgs_tpu_torch.utils import trace
from contextgs_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)

log = logging.getLogger("contextgs_tpu_torch")

EVAL_SEED = 0xE7A1    # eval noise is drawn outside the training stream


@dataclass
class TrainerState:
    model: SceneModel
    adam: AdamState
    voxel_size: float
    spatial_lr_scale: float
    generator: torch.Generator          # noise and densification draws
    level_scales: Optional[list] = None
    iteration: int = 0
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0))
    ranks: list = field(default_factory=list)   # sharded runs: per rank


@torch.no_grad()
def estimate_bits(model: SceneModel, cfg: TrainConfig,
                  ts: TrainerState) -> dict:
    """The model's estimate of its bitstream in MB per stream, the MLPs and
    the prior at 32 bits a parameter, and the total."""
    p, b = model.params, model.buffers
    maps = kept_level_maps(p, b, cfg.model, ts.voxel_size,
                           tuple(ts.level_scales or ()))
    bits = estimate_total_bits(p, b, cfg.model, maps, st.get_anchor(p, b),
                               disable_hyper=cfg.opt.disable_hyper)
    mb = {k: round(float(v) / 8 / 1024 / 1024, 4) for k, v in bits.items()}
    n_prior = sum(x.numel() for name, x in st.param_leaves(p).items()
                  if name.startswith("prior."))
    mb["mlp"] = round((count_mlp_params(p.mlps) + n_prior) * 32
                      / 8 / 1024 / 1024, 4)
    mb["total"] = round(sum(mb.values()), 4)
    return mb


def phase_of(it: int, cfg: TrainConfig) -> str:
    if it <= cfg.opt.noise_from:
        return "plain"
    if it <= cfg.opt.context_from:
        return "noise"
    return "context"


def grow_capacity(model: SceneModel, adam: AdamState,
                  new_capacity: int) -> tuple[SceneModel, AdamState]:
    """Pool enlargement: pads the anchor-indexed tensors with zeros."""
    n = model.buffers.alive.shape[0]
    extra = new_capacity - n
    if extra <= 0:
        return model, adam

    def pad(x):
        if x.dim() >= 1 and x.shape[0] == n:
            return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])
        return x

    params = model.params._replace(**{f: pad(getattr(model.params, f))
                                      for f in st.ANCHOR_FIELDS})
    buffers = Buffers(*(pad(x) for x in model.buffers))

    def pad_moments(moments):
        return {name: pad(x) if name in st.ANCHOR_FIELDS else x
                for name, x in moments.items()}

    adam = AdamState(mu=pad_moments(adam.mu), nu=pad_moments(adam.nu),
                     count=adam.count)
    return SceneModel(params, buffers), adam


def densify_counts(res, *more) -> list:
    """A densification round's counts (grown, pruned, whether it ran out
    of free slots), then the int64 scalars `more`, read back in one
    wait."""
    with trace.sync("densify.counts"):
        counts = torch.stack([res.n_grown, res.n_pruned,
                              res.overflowed.to(torch.int64), *more]).tolist()
    trace.count("anchors_grown", counts[0])
    trace.count("anchors_pruned", counts[1])
    return counts


def _to_image(cam, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(cam.image, (2, 0, 1)))).to(dev)


def start_state(cfg: TrainConfig, scene: SceneInfo, device,
                generator: torch.Generator, rank: int = 0,
                world: int = 1) -> tuple[TrainerState, list]:
    """A run's first state on `device` and its pending camera order: from
    the scene's points, or from `cfg.start_checkpoint` (either loop's or
    the JAX package's) read into a structure built from the config alone.
    Rank `rank` of `world` takes the checkpoint's `generator_state` (one
    process) or `generator_states[rank]` (as many ranks); else, and from a
    JAX checkpoint, `generator` keeps its seed."""
    ts = TrainerState(model=None, adam=None, voxel_size=cfg.model.voxel_size,
                      spatial_lr_scale=scene.radius, generator=generator,
                      rng=np.random.default_rng(cfg.seed))
    if not cfg.start_checkpoint:
        ts.model, ts.voxel_size = st.init_scene_model(
            scene.points, cfg.model,
            generator=torch.Generator().manual_seed(cfg.seed), device=device)
        ts.adam = init_adam(ts.model.params)
        return ts, []
    params, buffers, ts.adam, meta = load_checkpoint(
        cfg.start_checkpoint, st.blank_params(cfg.model, device=device),
        device)
    ts.model = SceneModel(params, buffers)
    ts.voxel_size = meta["voxel_size"]
    ts.level_scales = meta["level_scales"]
    ts.spatial_lr_scale = meta["spatial_lr_scale"]
    ts.iteration = meta["iteration"]
    ts.rng.bit_generator.state = meta["rng_state"]
    states = ([meta.get("generator_state")] if world == 1
              else meta.get("generator_states") or [])
    if len(states) == world and states[rank] is not None:
        generator.set_state(states[rank])
    log.info("resumed from %s at iteration %d", cfg.start_checkpoint,
             ts.iteration)
    return ts, list(meta["cam_order"])


def context_transition(params: Params, buffers: Buffers, ts: TrainerState,
                       cfg: TrainConfig) -> Buffers:
    """The context transition on a whole model: its anchor bounds
    refreshed, and once a run (a resume past it keeps the checkpoint's) the
    level scales searched over the kept anchors."""
    buffers = st.update_anchor_bound(buffers, params.anchor, buffers.alive)
    if ts.level_scales is None:
        kept = st.get_mask_anchor(params, buffers.alive)
        ts.level_scales = find_divide_scale(
            params.anchor[kept].cpu().numpy(), ts.voxel_size,
            buffers.bound_min.cpu().numpy(), buffers.bound_max.cpu().numpy(),
            cfg.model.target_ratio, cfg.model.level_num)
        log.info("level scales: %s", ts.level_scales)
    return buffers


def save_state(cfg: TrainConfig, ts: TrainerState, it: int, params: Params,
               buffers: Buffers, adam: AdamState, order: list,
               snapshot: bool, **meta) -> None:
    """The training checkpoint `chkpnt{it}.pt` of a whole state, `meta`
    added to its meta, and with `snapshot` the model snapshot
    `point_cloud/iteration_{it}/{point_cloud.ply, checkpoint.pth}` (ref
    scene/__init__.py:98-101), distinct from the checkpoint."""
    os.makedirs(cfg.model_path, exist_ok=True)
    save_checkpoint(
        os.path.join(cfg.model_path, f"chkpnt{it}.pt"), params, buffers,
        adam, dict(iteration=it, voxel_size=ts.voxel_size,
                   level_scales=ts.level_scales,
                   spatial_lr_scale=ts.spatial_lr_scale,
                   rng_state=ts.rng.bit_generator.state,
                   generator_state=ts.generator.get_state(),
                   cam_order=list(order), **meta))
    if snapshot:
        pc_dir = os.path.join(cfg.model_path, "point_cloud",
                              f"iteration_{it}")
        save_model_ply(os.path.join(pc_dir, "point_cloud.ply"), params,
                       buffers)
        save_networks(
            os.path.join(pc_dir, "checkpoint.pth"), params,
            extra=dict(bound_min=buffers.bound_min.cpu().numpy(),
                       bound_max=buffers.bound_max.cpu().numpy(),
                       level_scales=ts.level_scales,
                       voxel_size=ts.voxel_size, iteration=it))


class Run:
    """What a run does at each event of `run_schedule`, on the model in
    `ts`: this class on one device, `sharded_loop._Rank` on a rank's slab.
    It holds the views of the scene's training cameras on `device` and
    the step functions' other inputs."""

    def __init__(self, cfg: TrainConfig, scene: SceneInfo, ts: TrainerState,
                 device):
        self.cfg, self.ts, self.device = cfg, ts, device
        self.cams = scene.train_cameras
        self.test_cameras = scene.test_cameras
        self.cam_dicts = [c.as_device_dict() for c in self.cams]
        self.gts = [_to_image(c, device) for c in self.cams]
        self.bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                               else [0.0, 0.0, 0.0], dtype=torch.float32,
                               device=device)
        self.eval_fns: dict = {}

    def make_step(self, phase: str, width: int, height: int):
        """The step function of `phase` at a view size."""
        ts = self.ts
        return make_train_step(self.cfg, width, height, phase,
                               ts.spatial_lr_scale,
                               level_scales=ts.level_scales or (),
                               voxel_size=ts.voxel_size)

    def step(self, fn, ci: int, it: int, with_stats: bool):
        """Step `it` on training camera `ci` by `fn`; → its metrics."""
        ts = self.ts
        params, buffers, ts.adam, metrics = fn(
            ts.model.params, ts.model.buffers, ts.adam, self.cam_dicts[ci],
            self.gts[ci], self.bg, it, with_stats, ts.generator)
        ts.model = SceneModel(params, buffers)
        return metrics

    def enter_context(self) -> None:
        m = self.ts.model
        self.ts.model = SceneModel(m.params, context_transition(
            m.params, m.buffers, self.ts, self.cfg))
        self.eval_fns.clear()

    def densify(self, it: int) -> None:
        """A round on the model and Adam state in `ts`, the pool doubled
        where it ran out of free slots."""
        ts, cfg = self.ts, self.cfg
        res = densify.adjust_anchors(*ts.model, ts.adam, cfg.model, cfg.opt,
                                     ts.voxel_size, ts.generator)
        ts.model = model = SceneModel(res.params, res.buffers)
        ts.adam = res.adam
        grown, pruned, overflowed, alive = densify_counts(
            res, model.buffers.alive.sum())
        log.info("iter %d densify: grown %d, pruned %d, anchors %d", it,
                 grown, pruned, alive)
        if overflowed:
            with trace.span("train/pool_grow"):
                cap = model.buffers.alive.shape[0] * 2
                log.warning("anchor pool full at iter %d → growing to %d",
                            it, cap)
                ts.model, ts.adam = grow_capacity(model, ts.adam, cap)

    def report(self, it: int, phase: str, metrics) -> None:
        """After step `it` and its densification round: nothing here."""

    def evaluate(self, it: int, phase: str) -> None:
        """After the callback: the test cameras at `test_iterations`, the
        model's size estimate every 2000 context steps."""
        cfg, ts, dev = self.cfg, self.ts, self.device
        if it in cfg.test_iterations and self.test_cameras:
            # eval noise from its own generator: enabling test_iterations
            # does not perturb the training draws
            gen = torch.Generator(dev).manual_seed(EVAL_SEED * 100_003 + it)
            psnrs = []
            for c in self.test_cameras:
                ek = (phase, c.width, c.height)
                if ek not in self.eval_fns:
                    self.eval_fns[ek] = make_eval_render(
                        cfg, c.width, c.height, phase,
                        level_scales=ts.level_scales or (),
                        voxel_size=ts.voxel_size)
                img = self.eval_fns[ek](ts.model.params, ts.model.buffers,
                                        c.as_device_dict(), self.bg, gen)
                psnrs.append(float(psnr_fn(img, _to_image(c, dev))))
            log.info("iter %d test [%s]: PSNR %.3f over %d views", it, phase,
                     float(np.mean(psnrs)), len(psnrs))
        if phase == "context" and it % 2000 == 0:
            log.info("iter %d size estimate: %s", it,
                     estimate_bits(ts.model, cfg, ts))

    def n_alive(self) -> int:
        return st.n_alive(self.ts.model)

    def save(self, it: int, order: list, snapshot: bool) -> None:
        ts = self.ts
        save_state(self.cfg, ts, it, *ts.model, ts.adam, order, snapshot)


def run_schedule(cfg: TrainConfig, ts: TrainerState, run: Run, order: list,
                 callback=None) -> None:
    """Steps `ts.iteration + 1` through `cfg.opt.iterations`, `order` the
    cameras pending. A step takes the next camera of a random order from
    `ts.rng`, in the phase `phase_of` names, with the statistics inside
    (start_stat, update_until), and is followed, in order, by a
    densification round, `run.report`, `callback(it, ts, metrics)`,
    `run.evaluate`, the log line and the checkpoint (and snapshot)."""
    opt = cfg.opt
    cams = run.cams
    step_fns: dict = {}
    t_start = time.time()
    for it in range(ts.iteration + 1, opt.iterations + 1):
        ts.iteration = it
        phase = phase_of(it, cfg)
        if it == opt.context_from + 1:
            run.enter_context()
            step_fns.clear()
        if not order:
            order = [int(i) for i in ts.rng.permutation(len(cams))]
        ci = order.pop()

        key = (phase, cams[ci].width, cams[ci].height)
        if key not in step_fns:
            step_fns[key] = run.make_step(*key)
        metrics = run.step(step_fns[key], ci, it,
                           opt.start_stat < it < opt.update_until)
        if (opt.update_from < it < opt.update_until
                and it % opt.update_interval == 0
                and not (3000 <= it < 4000)):
            with trace.span("train/densify"):
                run.densify(it)
        run.report(it, phase, metrics)

        if callback is not None:
            callback(it, ts, metrics)
        run.evaluate(it, phase)
        if it % cfg.log_every == 0:
            with trace.sync("log", 4):
                logged = (float(metrics.loss), float(metrics.psnr),
                          float(metrics.bit_per_param), run.n_alive())
            log.info("iter %d [%s]: loss=%.5f psnr=%.2f bpp=%.4f anchors=%d",
                     it, phase, *logged)
        if ((it in cfg.checkpoint_iterations or it in cfg.save_iterations)
                and cfg.model_path):
            run.save(it, order, it in cfg.save_iterations)
    log.info("training done in %.1fs", time.time() - t_start)


def train(cfg: TrainConfig, scene: SceneInfo, *, device=None,
          callback=None) -> TrainerState:
    """Run the optimization on `device` (default: the CUDA card); returns
    the final trainer state. `callback(it, ts, metrics)` runs after every
    step."""
    dev = resolve_device(device)
    ts, order = start_state(cfg, scene, dev,
                            torch.Generator(dev).manual_seed(cfg.seed))
    log.info("init: %d anchors (capacity %d), voxel_size=%.6f",
             st.n_alive(ts.model), ts.model.buffers.alive.shape[0],
             ts.voxel_size)
    run_schedule(cfg, ts, Run(cfg, scene, ts, dev), order, callback)
    return ts
