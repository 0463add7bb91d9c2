"""Host-side training orchestration (port of `contextgs_tpu/train/loop.py`).

Random camera order from a numpy Generator, the per-phase schedule (plain,
noise, context), densification every `update_interval` steps inside
(update_from, update_until) except in [3000, 4000), pool growth when
densification runs out of free slots, the anchor-bound refresh and the
level-scale search at the context transition, the model's size estimate
every 2000 context steps, the `test_iterations` evaluation, logging,
checkpoints and resume.

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
from contextgs_tpu_torch.models.state import Buffers, SceneModel
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


def _densify_round(ts: TrainerState, cfg: TrainConfig,
                   it: int) -> SceneModel:
    """One densification round on `ts` (its model and Adam state replaced),
    the pool doubled where the round ran out of free slots; its counts
    come back to the host in one read."""
    model = ts.model
    res = densify.adjust_anchors(model.params, model.buffers, ts.adam,
                                 cfg.model, cfg.opt, ts.voxel_size,
                                 ts.generator)
    ts.model = model = SceneModel(res.params, res.buffers)
    ts.adam = res.adam
    with trace.sync("densify.counts"):
        grown, pruned, alive, overflowed = torch.stack([
            res.n_grown, res.n_pruned, model.buffers.alive.sum(),
            res.overflowed.to(torch.int64)]).tolist()
    trace.count("anchors_grown", grown)
    trace.count("anchors_pruned", pruned)
    log.info("iter %d densify: grown %d, pruned %d, anchors %d", it, grown,
             pruned, alive)
    if overflowed:
        with trace.span("train/pool_grow"):
            cap = model.buffers.alive.shape[0] * 2
            log.warning("anchor pool full at iter %d → growing to %d", it,
                        cap)
            model, ts.adam = grow_capacity(model, ts.adam, cap)
            ts.model = model
    return model


def _to_image(cam, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(cam.image, (2, 0, 1)))).to(dev)


def train(cfg: TrainConfig, scene: SceneInfo, *, device=None,
          callback=None) -> TrainerState:
    """Run the optimization on `device` (default: the CUDA card); returns
    the final trainer state. `callback(it, ts, metrics)` runs after every
    step."""
    dev = resolve_device(device)
    opt = cfg.opt
    model, voxel_size = st.init_scene_model(
        scene.points, cfg.model,
        generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    ts = TrainerState(model=model, adam=init_adam(model.params),
                      voxel_size=voxel_size, spatial_lr_scale=scene.radius,
                      generator=torch.Generator(dev).manual_seed(cfg.seed),
                      rng=np.random.default_rng(cfg.seed))
    order: list = []
    if cfg.start_checkpoint:
        params, buffers, ts.adam, meta = load_checkpoint(
            cfg.start_checkpoint, model.params, dev)
        ts.model = model = SceneModel(params, buffers)
        ts.voxel_size = meta["voxel_size"]
        ts.level_scales = meta["level_scales"]
        ts.spatial_lr_scale = meta["spatial_lr_scale"]
        ts.iteration = meta["iteration"]
        ts.rng.bit_generator.state = meta["rng_state"]
        if "generator_state" in meta:      # absent from a JAX checkpoint
            ts.generator.set_state(meta["generator_state"])
        order = list(meta["cam_order"])
        log.info("resumed from %s at iteration %d", cfg.start_checkpoint,
                 ts.iteration)
    log.info("init: %d anchors (capacity %d), voxel_size=%.6f",
             st.n_alive(model), model.buffers.alive.shape[0], ts.voxel_size)

    cams = scene.train_cameras
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    cam_dicts = [c.as_device_dict() for c in cams]
    gts = [_to_image(c, dev) for c in cams]
    step_fns: dict = {}
    eval_fns: dict = {}

    t_start = time.time()
    for it in range(ts.iteration + 1, opt.iterations + 1):
        ts.iteration = it
        phase = phase_of(it, cfg)
        if it == opt.context_from + 1:
            # the context transition: refresh the anchor bounds, search the
            # level scales once over the kept anchors
            model = ts.model = SceneModel(model.params, st.update_anchor_bound(
                model.buffers, model.params.anchor, model.buffers.alive))
            if ts.level_scales is None:
                kept = st.get_mask_anchor(model.params, model.buffers.alive)
                ts.level_scales = find_divide_scale(
                    model.params.anchor[kept].cpu().numpy(), ts.voxel_size,
                    model.buffers.bound_min.cpu().numpy(),
                    model.buffers.bound_max.cpu().numpy(),
                    cfg.model.target_ratio, cfg.model.level_num)
                log.info("level scales: %s", ts.level_scales)
            step_fns.clear()
            eval_fns.clear()
        if not order:
            order = [int(i) for i in ts.rng.permutation(len(cams))]
        ci = order.pop()

        lk = (phase, cams[ci].width, cams[ci].height)
        if lk not in step_fns:
            step_fns[lk] = make_train_step(
                cfg, lk[1], lk[2], phase, ts.spatial_lr_scale,
                level_scales=ts.level_scales or (), voxel_size=ts.voxel_size)
        params, buffers, adam, metrics = step_fns[lk](
            model.params, model.buffers, ts.adam, cam_dicts[ci], gts[ci], bg,
            it, opt.start_stat < it < opt.update_until, ts.generator)
        ts.model = model = SceneModel(params, buffers)
        ts.adam = adam

        if (opt.update_from < it < opt.update_until
                and it % opt.update_interval == 0
                and not (3000 <= it < 4000)):
            with trace.span("train/densify"):
                model = _densify_round(ts, cfg, it)

        if callback is not None:
            callback(it, ts, metrics)
        if it in cfg.test_iterations and scene.test_cameras:
            # eval noise from its own generator: enabling test_iterations
            # does not perturb the training draws
            gen = torch.Generator(dev).manual_seed(EVAL_SEED * 100_003 + it)
            psnrs = []
            for c in scene.test_cameras:
                ek = (phase, c.width, c.height)
                if ek not in eval_fns:
                    eval_fns[ek] = make_eval_render(
                        cfg, c.width, c.height, phase,
                        level_scales=ts.level_scales or (),
                        voxel_size=ts.voxel_size)
                img = eval_fns[ek](model.params, model.buffers,
                                   c.as_device_dict(), bg, gen)
                psnrs.append(float(psnr_fn(img, _to_image(c, dev))))
            log.info("iter %d test [%s]: PSNR %.3f over %d views", it, phase,
                     float(np.mean(psnrs)), len(psnrs))
        if it % cfg.log_every == 0:
            with trace.sync("log", 4):
                logged = (float(metrics.loss), float(metrics.psnr),
                          float(metrics.bit_per_param), st.n_alive(model))
            log.info("iter %d [%s]: loss=%.5f psnr=%.2f bpp=%.4f anchors=%d",
                     it, phase, *logged)
        if phase == "context" and it % 2000 == 0:
            log.info("iter %d size estimate: %s", it,
                     estimate_bits(model, cfg, ts))

        if ((it in cfg.checkpoint_iterations or it in cfg.save_iterations)
                and cfg.model_path):
            os.makedirs(cfg.model_path, exist_ok=True)
            save_checkpoint(
                os.path.join(cfg.model_path, f"chkpnt{it}.pt"), model.params,
                model.buffers, ts.adam,
                dict(iteration=it, voxel_size=ts.voxel_size,
                     level_scales=ts.level_scales,
                     spatial_lr_scale=ts.spatial_lr_scale,
                     rng_state=ts.rng.bit_generator.state,
                     generator_state=ts.generator.get_state(),
                     cam_order=list(order)))
        if it in cfg.save_iterations and cfg.model_path:
            # the model snapshot (ref scene/__init__.py:98-101), distinct
            # from the training checkpoint
            pc_dir = os.path.join(cfg.model_path, "point_cloud",
                                  f"iteration_{it}")
            save_model_ply(os.path.join(pc_dir, "point_cloud.ply"),
                           model.params, model.buffers)
            save_networks(
                os.path.join(pc_dir, "checkpoint.pth"), model.params,
                extra=dict(
                    bound_min=model.buffers.bound_min.cpu().numpy(),
                    bound_max=model.buffers.bound_max.cpu().numpy(),
                    level_scales=ts.level_scales,
                    voxel_size=ts.voxel_size, iteration=it))

    log.info("training done in %.1fs", time.time() - t_start)
    return ts
