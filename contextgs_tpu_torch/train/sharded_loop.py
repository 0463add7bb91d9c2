"""Multi-GPU training orchestration, the loop behind `drivers.train --mesh N`
(port of `contextgs_tpu/train/sharded_loop.py`).

`train_sharded` spawns one process a rank (`parallel.comm.spawn`) and
composes the sharded primitives of `parallel/sharded.py` into a full run
with the single-process loop's schedule (`train/loop.py`):

- phases plain → noise → context, with the anchor-bound refresh, the
  level-scale search and a reshard by context-tree root at the transition;
- sharded densification at the loop's cadence, each round followed by the
  host-side reshard (global voxel dedup, whole trees on one shard), which
  also grows the capacity twofold when a rank's pool ran out;
- checkpoints at `checkpoint_iterations` and `save_iterations`, in the
  single-process format (`chkpnt{it}.pt`, `n_devices` in its meta), and the
  PLY snapshot at a save iteration, both written by rank 0 from the
  gathered model, so that `drivers.test`, `drivers.decompress` and either
  loop resume from them;
- resume from such a checkpoint (of either loop);
- the final model gathered and returned to the caller, whose encode runs on
  it as after `train()`.

Every rank takes the same camera order (one numpy Generator from the seed)
and its own torch Generator, seeded from (seed, rank). The JAX loop's
instance budget and its overflow doubling have no counterpart: the port's
shapes are dynamic.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from contextgs_tpu_torch.config import TrainConfig
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.levels import find_divide_scale
from contextgs_tpu_torch.models.state import SceneModel
from contextgs_tpu_torch.ops.rasterize import tile_kernel
from contextgs_tpu_torch.parallel import comm as pcomm
from contextgs_tpu_torch.parallel.sharded import (gather_model,
                                                  make_sharded_densify,
                                                  make_sharded_train_step,
                                                  net_state, reshard_anchors,
                                                  shard_model)
from contextgs_tpu_torch.scene.dataset_readers import SceneInfo
from contextgs_tpu_torch.scene.snapshot import save_model_ply, save_networks
from contextgs_tpu_torch.train.loop import TrainerState, phase_of
from contextgs_tpu_torch.train.optim import init_adam
from contextgs_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)

log = logging.getLogger("contextgs_tpu_torch")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s torch Generator."""
    return seed * 1_000_003 + rank


def train_sharded(cfg: TrainConfig, scene: SceneInfo, n_devices: int, *,
                  device=None, backend: str | None = None, callback=None,
                  timeout: float | None = None,
                  detect_anomaly: bool = False) -> TrainerState:
    """Run the optimization on `n_devices` ranks; → the final trainer state
    with the model gathered onto `device` (default: the CUDA card), and
    each rank's report (launches, timings, memory, replicated parameters)
    in `ts.ranks`.

    On the card each rank takes card rank % device_count over NCCL, and
    more ranks than cards raise unless `backend="gloo"` (ranks then share
    cards, and gloo carries the collectives through host memory). On the
    CPU (`device="cpu"`) the ranks run gloo. `callback(it, ts, metrics)`
    runs on rank 0 after every step (so it must pickle: a module-level
    function or an object of a module-level class); `ts.model` is then
    rank 0's slab. `detect_anomaly` turns on
    `torch.autograd.set_detect_anomaly` in every rank. The kernels are
    built here, before the spawn."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if backend == "nccl" and n_devices > torch.cuda.device_count():
            raise RuntimeError(
                f"{n_devices} ranks over NCCL need {n_devices} CUDA devices, "
                f"this machine has {torch.cuda.device_count()} (NCCL refuses "
                "two ranks on one device; run the ranks on the CPU instead)")
        from contextgs_tpu_torch.ops import cuda_build
        cuda_build.build(tile_kernel.SOURCES)
    elif backend != "gloo":
        raise ValueError(f"ranks on the CPU run gloo, not {backend}")
    results = pcomm.spawn(
        _train_rank, n_devices,
        (cfg, scene, callback, logging.getLogger(log.name).getEffectiveLevel(),
         detect_anomaly),
        backend=backend, device_type=dev.type, timeout=timeout)
    final = results[0]["final"]
    params, buffers, adam = _to_device(*final["state"], dev)
    ts = TrainerState(model=SceneModel(params, buffers), adam=adam,
                      voxel_size=final["voxel_size"],
                      spatial_lr_scale=final["spatial_lr_scale"],
                      generator=torch.Generator(dev).manual_seed(cfg.seed),
                      level_scales=final["level_scales"],
                      iteration=final["iteration"])
    ts.rng.bit_generator.state = final["rng_state"]
    ts.ranks = [r["report"] for r in results]
    return ts


def _to_device(params, buffers, adam, dev):
    """A full host state onto `dev`."""
    params = params._replace(
        mlps=params.mlps.to(dev),
        prior=None if params.prior is None else type(params.prior)(
            *(tuple(x.to(dev) for x in f) for f in params.prior)),
        **{f: getattr(params, f).to(dev) for f in st.ANCHOR_FIELDS})
    buffers = type(buffers)(*(x.to(dev) for x in buffers))
    adam = type(adam)(mu={k: x.to(dev) for k, x in adam.mu.items()},
                      nu={k: x.to(dev) for k, x in adam.nu.items()},
                      count=adam.count)
    return params, buffers, adam


def _train_rank(mesh, cfg: TrainConfig, scene: SceneInfo, callback,
                log_level: int, detect_anomaly: bool = False) -> dict:
    """The rank body of `train_sharded`."""
    logs = contextlib.nullcontext(log)
    if mesh.rank == 0 and log_level <= logging.INFO:
        from contextgs_tpu_torch import drivers
        logs = drivers.logging_to(cfg.model_path)
    with logs, torch.autograd.set_detect_anomaly(detect_anomaly):
        return _train(mesh, cfg, scene, callback)


def _train(mesh, cfg: TrainConfig, scene: SceneInfo, callback) -> dict:
    dev, n_dev, rank = mesh.device, mesh.world, mesh.rank
    lead = rank == 0
    opt = cfg.opt
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    model, voxel_size = st.init_scene_model(
        scene.points, cfg.model,
        generator=torch.Generator().manual_seed(cfg.seed), device="cpu")
    ts = TrainerState(model=model, adam=init_adam(model.params),
                      voxel_size=voxel_size, spatial_lr_scale=scene.radius,
                      generator=torch.Generator(dev).manual_seed(
                          rank_seed(cfg.seed, rank)),
                      rng=np.random.default_rng(cfg.seed))
    hp, hb, ha = model.params, model.buffers, ts.adam
    order: list = []
    if cfg.start_checkpoint:
        hp, hb, ha, meta = load_checkpoint(cfg.start_checkpoint, hp, "cpu")
        ts.voxel_size = meta["voxel_size"]
        ts.level_scales = meta["level_scales"]
        ts.spatial_lr_scale = meta["spatial_lr_scale"]
        ts.iteration = meta["iteration"]
        ts.rng.bit_generator.state = meta["rng_state"]
        states = meta.get("generator_states")
        if states is not None and len(states) == n_dev:
            ts.generator.set_state(states[rank])
        order = list(meta["cam_order"])
        if lead:
            log.info("resumed (sharded) from %s at iteration %d",
                     cfg.start_checkpoint, ts.iteration)

    # the first placement: the spatial hash (or the tree roots, on a resume
    # in the context phase) balances the free slots over the ranks
    hp, hb, ha, info = reshard_anchors(
        hp, hb, ha, n_dev, ts.voxel_size,
        level_scales=tuple(ts.level_scales or ()),
        level_num=cfg.model.level_num)
    sp, sb, sa = shard_model(mesh, hp, hb, ha)
    del hp, hb, ha, model
    if lead:
        log.info("sharded init: %d anchors over %d ranks (capacity %d), "
                 "voxel_size=%.6f", info["n_alive"], n_dev, info["capacity"],
                 ts.voxel_size)

    cams = scene.train_cameras
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    cam_dicts = [c.as_device_dict() for c in cams]
    gts = [torch.from_numpy(np.ascontiguousarray(
        np.transpose(c.image, (2, 0, 1)))).to(dev) for c in cams]
    step_fns: dict = {}
    densify_fn = None
    report = dict(rank=rank, world=n_dev, backend=mesh.backend,
                  device=str(dev), steps=[], reshard_s=[], densify=[],
                  anomaly_mode=torch.is_anomaly_enabled())

    def reshard(min_capacity: int = 0, context_transition: bool = False):
        nonlocal sp, sb, sa
        t0 = time.perf_counter()
        hp_, hb_, ha_ = gather_model(mesh, sp, sb, sa)
        if context_transition:
            # refresh the bounds, search the level scales once, over every
            # rank's anchors; the reshard then keys shards by tree root
            hb_ = st.update_anchor_bound(hb_, hp_.anchor, hb_.alive)
            if ts.level_scales is None:
                kept = st.get_mask_anchor(hp_, hb_.alive)
                ts.level_scales = find_divide_scale(
                    hp_.anchor[kept].numpy(), ts.voxel_size,
                    hb_.bound_min.numpy(), hb_.bound_max.numpy(),
                    cfg.model.target_ratio, cfg.model.level_num)
                if lead:
                    log.info("level scales: %s", ts.level_scales)
        hp_, hb_, ha_, info_ = reshard_anchors(
            hp_, hb_, ha_, n_dev, ts.voxel_size,
            level_scales=tuple(ts.level_scales or ()),
            level_num=cfg.model.level_num, min_capacity=min_capacity)
        sp, sb, sa = shard_model(mesh, hp_, hb_, ha_)
        if cuda:
            torch.cuda.synchronize(dev)
        report["reshard_s"].append(time.perf_counter() - t0)
        return info_

    def n_alive() -> int:
        return int(mesh.psum(sb.alive.sum()[None]))

    t_start = t_prev = time.perf_counter()
    for it in range(ts.iteration + 1, opt.iterations + 1):
        ts.iteration = it
        phase = phase_of(it, cfg)
        if it == opt.context_from + 1:
            reshard(context_transition=True)
            step_fns.clear()
        if not order:
            order = [int(i) for i in ts.rng.permutation(len(cams))]
        ci = order.pop()

        lk = (phase, cams[ci].width, cams[ci].height)
        if lk not in step_fns:
            step_fns[lk] = make_sharded_train_step(
                cfg, mesh, lk[1], lk[2], phase, ts.spatial_lr_scale,
                level_scales=ts.level_scales or (),
                voxel_size=ts.voxel_size)
        sp, sb, sa, metrics = step_fns[lk](
            sp, sb, sa, cam_dicts[ci], gts[ci], bg, it,
            opt.start_stat < it < opt.update_until, ts.generator)

        grown = None
        if (opt.update_from < it < opt.update_until
                and it % opt.update_interval == 0
                and not (3000 <= it < 4000)):
            if densify_fn is None:
                densify_fn = make_sharded_densify(cfg, mesh, ts.voxel_size)
            res = densify_fn(sp, sb, sa, ts.generator)
            sp, sb, sa = res.params, res.buffers, res.adam
            min_cap = 0
            if bool(res.overflowed):
                min_cap = sb.alive.shape[0] * n_dev * 2
                if lead:
                    log.warning("sharded anchor pool full at iter %d → "
                                "growing to %d", it, min_cap)
            info = reshard(min_capacity=min_cap)
            grown = (int(res.n_grown), int(res.n_pruned), info["n_alive"],
                     info["n_dupes_removed"], info["capacity"])
            report["densify"].append((it,) + grown)
            if lead:
                log.info("iter %d densify: grown %d, pruned %d, anchors %d "
                         "(%d duplicates removed, capacity %d)", it, *grown)
        if cuda:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        report["steps"].append(dict(
            it=it, phase=phase, ms=(now - t_prev) * 1e3,
            loss=float(metrics.loss), psnr=float(metrics.psnr),
            bit_per_param=float(metrics.bit_per_param),
            splat_bytes=mesh.splat_log[-1][0],
            splat_ms=mesh.splat_log[-1][1]))
        t_prev = now

        ts.model = SceneModel(sp, sb)
        if lead and callback is not None:
            callback(it, ts, metrics)
        if it % cfg.log_every == 0:
            alive = n_alive()
            if lead:
                log.info("iter %d [%s] (mesh %d): loss=%.5f psnr=%.2f "
                         "bpp=%.4f anchors=%d", it, phase, n_dev,
                         float(metrics.loss), float(metrics.psnr),
                         float(metrics.bit_per_param), alive)

        if ((it in cfg.checkpoint_iterations or it in cfg.save_iterations)
                and cfg.model_path):
            full = gather_model(mesh, sp, sb, sa)
            gens = mesh.all_gather(ts.generator.get_state()[None]).cpu()
            if lead:
                _save(cfg, ts, it, full, [g for g in gens], order, n_dev)
            mesh.barrier()

    full = _to_device(*gather_model(mesh, sp, sb, sa), torch.device("cpu"))
    if lead:
        log.info("sharded training done in %.1fs",
                 time.perf_counter() - t_start)
    report.update(
        k1_launches=tile_kernel.launches,
        k2_launches=tile_kernel.backward_launches,
        peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                      if cuda else None),
        foreign_modules=pcomm.foreign_modules(), net=net_state(sp))
    out = dict(report=report)
    if lead:
        out["final"] = dict(state=full, voxel_size=ts.voxel_size,
                            spatial_lr_scale=ts.spatial_lr_scale,
                            level_scales=ts.level_scales,
                            iteration=ts.iteration,
                            rng_state=ts.rng.bit_generator.state)
    return out


def _save(cfg: TrainConfig, ts: TrainerState, it: int, full, gens: list,
          order: list, n_dev: int) -> None:
    """Rank 0: the checkpoint, and at a save iteration the snapshot, of the
    gathered state, as the single-process loop writes them."""
    params, buffers, adam = full
    os.makedirs(cfg.model_path, exist_ok=True)
    save_checkpoint(
        os.path.join(cfg.model_path, f"chkpnt{it}.pt"), params, buffers,
        adam, dict(iteration=it, voxel_size=ts.voxel_size,
                   level_scales=ts.level_scales,
                   spatial_lr_scale=ts.spatial_lr_scale,
                   rng_state=ts.rng.bit_generator.state,
                   generator_state=gens[0], generator_states=gens,
                   cam_order=list(order), n_devices=n_dev))
    if it in cfg.save_iterations:
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
