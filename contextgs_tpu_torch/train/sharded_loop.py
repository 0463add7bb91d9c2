"""Multi-GPU training orchestration, the loop behind `drivers.train --mesh N`
(port of `contextgs_tpu/train/sharded_loop.py`).

`train_sharded` spawns one process a rank (`parallel.comm.spawn`). Each
rank runs the single-process schedule, `train/loop.run_schedule`, and its
resume, `loop.start_state`, on its slab of the model through `_Rank`, which
supplies what a rank does differently with the sharded primitives of
`parallel/sharded.py`: the first placement; the reshard (global voxel
dedup, whole trees on one shard) at the context transition, which runs on
the gathered model, and after each sharded densification round, where it
also doubles the capacity when a rank's pool ran out; the checkpoint and
snapshot, written by rank 0 from the gathered model with every rank's
generator state and `n_devices` in its meta; a per-step report (timings,
splat bytes); and the final model, gathered for the caller.

Every rank takes the same camera order (one numpy Generator from the seed)
and its own torch Generator, seeded from (seed, rank). The JAX loop's
instance budget and its overflow doubling have no counterpart: the port's
shapes are dynamic.
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

from contextgs_tpu_torch.config import TrainConfig
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.state import SceneModel
from contextgs_tpu_torch.ops.rasterize import tile_kernel
from contextgs_tpu_torch.parallel import comm as pcomm
from contextgs_tpu_torch.parallel.sharded import (gather_model,
                                                  make_sharded_densify,
                                                  make_sharded_train_step,
                                                  net_state, reshard_anchors,
                                                  shard_model)
from contextgs_tpu_torch.scene.dataset_readers import SceneInfo
from contextgs_tpu_torch.train import loop
from contextgs_tpu_torch.train.loop import TrainerState

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
    """The rank body of `train_sharded`: rank 0 alone logs."""
    logs = contextlib.nullcontext(log)
    if mesh.rank:
        log.setLevel(logging.ERROR)
    elif log_level <= logging.INFO:
        from contextgs_tpu_torch import drivers
        logs = drivers.logging_to(cfg.model_path)
    with logs, torch.autograd.set_detect_anomaly(detect_anomaly):
        return _train(mesh, cfg, scene, callback)


class _Rank(loop.Run):
    """A rank's run: `ts.model` and `ts.adam` hold its slab."""

    def __init__(self, mesh, cfg, scene, ts):
        super().__init__(cfg, scene, ts, mesh.device)
        self.mesh, self.densify_fn = mesh, None
        self.rank_report = dict(
            rank=mesh.rank, world=mesh.world, backend=mesh.backend,
            device=str(mesh.device), steps=[], reshard_s=[], densify=[],
            anomaly_mode=torch.is_anomaly_enabled())
        # the first placement: the spatial hash (or the tree roots, on a
        # resume in the context phase) balances the free slots over the ranks
        info = self.place(*ts.model, ts.adam)
        log.info("sharded init: %d anchors over %d ranks (capacity %d), "
                 "voxel_size=%.6f", info["n_alive"], mesh.world,
                 info["capacity"], ts.voxel_size)
        self.t_prev = time.perf_counter()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evaluate(self, it, phase):
        pass    # as the JAX sharded loop, no evaluation while training

    def place(self, params, buffers, adam, min_capacity: int = 0) -> dict:
        """A whole host state dealt out over the ranks: this rank's slab
        into `ts`."""
        ts, mesh = self.ts, self.mesh
        params, buffers, adam, info = reshard_anchors(
            params, buffers, adam, mesh.world, ts.voxel_size,
            level_scales=tuple(ts.level_scales or ()),
            level_num=self.cfg.model.level_num, min_capacity=min_capacity)
        params, buffers, ts.adam = shard_model(mesh, params, buffers, adam)
        ts.model = SceneModel(params, buffers)
        return info

    def reshard(self, min_capacity: int = 0,
                context_transition: bool = False) -> dict:
        """Every rank's anchors gathered and placed anew; at the context
        transition the gathered model takes it first, and the shards are
        keyed by tree root from then on."""
        t0 = time.perf_counter()
        params, buffers, adam = gather_model(self.mesh, *self.ts.model,
                                             self.ts.adam)
        if context_transition:
            buffers = loop.context_transition(params, buffers, self.ts,
                                              self.cfg)
        info = self.place(params, buffers, adam, min_capacity)
        self.sync()
        self.rank_report["reshard_s"].append(time.perf_counter() - t0)
        return info

    def make_step(self, phase, width, height):
        ts = self.ts
        return make_sharded_train_step(
            self.cfg, self.mesh, width, height, phase, ts.spatial_lr_scale,
            level_scales=ts.level_scales or (), voxel_size=ts.voxel_size)

    def enter_context(self):
        self.reshard(context_transition=True)

    def densify(self, it):
        ts = self.ts
        if self.densify_fn is None:
            self.densify_fn = make_sharded_densify(self.cfg, self.mesh,
                                                   ts.voxel_size)
        res = self.densify_fn(*ts.model, ts.adam, ts.generator)
        ts.model, ts.adam = SceneModel(res.params, res.buffers), res.adam
        grown, pruned, overflowed = loop.densify_counts(res)
        min_cap = 0
        if overflowed:
            min_cap = res.buffers.alive.shape[0] * self.mesh.world * 2
            log.warning("sharded anchor pool full at iter %d → growing to "
                        "%d", it, min_cap)
        info = self.reshard(min_capacity=min_cap)
        counts = (grown, pruned, info["n_alive"], info["n_dupes_removed"],
                  info["capacity"])
        self.rank_report["densify"].append((it,) + counts)
        log.info("iter %d densify: grown %d, pruned %d, anchors %d (%d "
                 "duplicates removed, capacity %d)", it, *counts)

    def report(self, it, phase, metrics):
        self.sync()
        now = time.perf_counter()
        splat_bytes, splat_ms = self.mesh.splat_log[-1]
        self.rank_report["steps"].append(dict(
            it=it, phase=phase, ms=(now - self.t_prev) * 1e3,
            loss=float(metrics.loss), psnr=float(metrics.psnr),
            bit_per_param=float(metrics.bit_per_param),
            splat_bytes=splat_bytes, splat_ms=splat_ms))
        self.t_prev = now

    def n_alive(self):
        return int(self.mesh.psum(self.ts.model.buffers.alive.sum()[None]))

    def save(self, it, order, snapshot):
        ts, mesh = self.ts, self.mesh
        full = gather_model(mesh, *ts.model, ts.adam)
        gens = mesh.all_gather(ts.generator.get_state()[None]).cpu()
        if mesh.rank == 0:
            loop.save_state(self.cfg, ts, it, *full, order, snapshot,
                            generator_states=list(gens),
                            n_devices=mesh.world)
        mesh.barrier()


def _train(mesh, cfg: TrainConfig, scene: SceneInfo, callback) -> dict:
    dev, lead = mesh.device, mesh.rank == 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ts, order = loop.start_state(
        cfg, scene, "cpu",
        torch.Generator(dev).manual_seed(rank_seed(cfg.seed, mesh.rank)),
        mesh.rank, mesh.world)
    rank = _Rank(mesh, cfg, scene, ts)
    loop.run_schedule(cfg, ts, rank, order, callback if lead else None)

    full = _to_device(*gather_model(mesh, *ts.model, ts.adam),
                      torch.device("cpu"))
    report = rank.rank_report
    report.update(
        k1_launches=tile_kernel.launches,
        k2_launches=tile_kernel.backward_launches,
        peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                      if dev.type == "cuda" else None),
        foreign_modules=pcomm.foreign_modules(),
        net=net_state(ts.model.params))
    out = dict(report=report)
    if lead:
        out["final"] = dict(state=full, voxel_size=ts.voxel_size,
                            spatial_lr_scale=ts.spatial_lr_scale,
                            level_scales=ts.level_scales,
                            iteration=ts.iteration,
                            rng_state=ts.rng.bit_generator.state)
    return out
