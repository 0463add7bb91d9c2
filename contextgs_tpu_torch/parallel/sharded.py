"""Multi-GPU training: anchors sharded, image tiles banded, gradients summed
(port of `contextgs_tpu/parallel/sharded.py` to `torch.distributed`).

- One process a rank (`comm.spawn`), one `Comm` ("mesh") a rank.
- Anchor-indexed parameters, buffers and Adam moments are sharded on dim 0
  as equal-capacity slabs (`shard_model`); the MLPs and the prior are
  replicated. The per-anchor stages (level maps, context, decode, rate) run
  on the rank's own anchors with no communication.
- Each rank decodes its visible anchors and all-gathers only the
  screen-space splat state (17 floats a gaussian, padded to the largest
  rank's count with valid=False), rank-major, the order of JAX's
  `all_gather(tiled=True)`, so the stable depth sort breaks ties alike.
- Each rank rasterizes its own horizontal band of tile rows through K1 (K2
  in the backward) with the kernels' row offset; bands past the image
  render background, so every rank's shapes agree.
- Each rank backpropagates its own partial loss: its band's L1 and SSIM
  terms and its share of the scaling and mask regularizers and of the
  rate, each over the global count. The gather's backward sums every band's
  cotangent on the home rank; the replicated gradients are summed over
  ranks once, so Adam leaves the replicated parameters equal on every rank.
- The densify statistics: the zero `screen_dummy` rides the gather, its
  cotangent is each gaussian's full-image gradient; visibility is a
  `psum_scatter` of the band flags.
- Densify runs per shard against every rank's voxel keys
  (`make_sharded_densify`); a host-side `reshard_anchors` at densify
  cadence deduplicates voxels globally and keeps each context tree on one
  shard, so the per-shard level maps are the global hierarchy restricted
  to the shard.

As in the reference, SSIM is band-local and pixel-weighted (its window does
not cross band seams), and two ranks may grow the same voxel within one
densify interval (removed at the next reshard, keep-first). Unlike the
reference's sharded step, the noise phase adds its quantization noise (the
reference's sharded step decodes the raw parameters there); the prefilter
tests the scaling the phase decodes, as the reference's sharded step does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from contextgs_tpu_torch.config import TrainConfig
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.decode import (generate_neural_gaussians,
                                               phase_inputs)
from contextgs_tpu_torch.models.densify import (accumulate_stats,
                                                adjust_anchors)
from contextgs_tpu_torch.models.levels import build_level_maps
from contextgs_tpu_torch.models.quant import ANCHOR_ROUND_DIGITS, Q_ANCHOR
from contextgs_tpu_torch.models.renderer import camera_tensors
from contextgs_tpu_torch.models.state import ANCHOR_FIELDS, Buffers, Params
from contextgs_tpu_torch.ops import rasterize as rz
from contextgs_tpu_torch.ops.ssim import ssim
from contextgs_tpu_torch.parallel.comm import Comm, init_group
from contextgs_tpu_torch.train.optim import AdamState, adam_update
from contextgs_tpu_torch.train.step import (StepMetrics, _check_phase,
                                            _grad_leaves, kept_level_maps)

# the Buffers fields indexed by anchor slot
ANCHOR_BUFFERS = ("alive", "opacity_accum", "anchor_denom",
                  "offset_grad_accum", "offset_denom")
# columns of the gathered splat state: xyz, scaling, rot, color, opacity,
# screen_dummy, valid
SPLAT = (3, 3, 4, 3, 1, 2, 1)


# the reference's `make_mesh`: this process's rank of the group
make_mesh = init_group


def _anchor_tensors(params: Params, buffers: Buffers,
                    adam: AdamState) -> dict:
    """Every anchor-indexed tensor of the training state, by name."""
    out = {f"p.{f}": getattr(params, f) for f in ANCHOR_FIELDS}
    out.update({f"b.{f}": getattr(buffers, f) for f in ANCHOR_BUFFERS})
    for m, moments in (("mu", adam.mu), ("nu", adam.nu)):
        out.update({f"{m}.{f}": moments[f] for f in ANCHOR_FIELDS})
    return out


def _with_anchor_tensors(params: Params, buffers: Buffers, adam: AdamState,
                         tensors: dict):
    """The state with its anchor-indexed tensors replaced by `tensors`."""
    params = params._replace(**{f: tensors[f"p.{f}"] for f in ANCHOR_FIELDS})
    buffers = buffers._replace(**{f: tensors[f"b.{f}"]
                                  for f in ANCHOR_BUFFERS})
    mu, nu = dict(adam.mu), dict(adam.nu)
    for m, moments in (("mu", mu), ("nu", nu)):
        moments.update({f: tensors[f"{m}.{f}"] for f in ANCHOR_FIELDS})
    return params, buffers, AdamState(mu=mu, nu=nu, count=adam.count)


def _pack(tensors: dict) -> torch.Tensor:
    """[n, ...] tensors → one [n, F] float32 matrix (exact: float32 values
    and booleans)."""
    n = next(iter(tensors.values())).shape[0]
    return torch.cat([x.reshape(n, -1).to(torch.float32)
                      for x in tensors.values()], 1)


def _unpack(flat: torch.Tensor, like: dict) -> dict:
    """The inverse of `_pack`, with the trailing shapes and dtypes of
    `like`."""
    out, c = {}, 0
    n = flat.shape[0]
    for name, x in like.items():
        w = int(np.prod(x.shape[1:], dtype=np.int64))
        out[name] = flat[:, c:c + w].reshape((n,) + tuple(x.shape[1:])).to(
            x.dtype)
        c += w
    return out


def gather_model(mesh: Comm, params: Params, buffers: Buffers,
                 adam: AdamState):
    """Every rank's slab, gathered: the full state with its anchor-indexed
    tensors on the host (rank-major rows); the replicated parts are this
    rank's."""
    like = _anchor_tensors(params, buffers, adam)
    full = mesh.all_gather(_pack(like)).cpu()
    return _with_anchor_tensors(params, buffers, adam, _unpack(full, like))


def shard_model(mesh: Comm, params: Params, buffers: Buffers,
                adam: AdamState):
    """This rank's slab of a full state (capacity a multiple of the world
    size): rows [rank·n/world, (rank+1)·n/world) of every anchor-indexed
    tensor, and the replicated parts, on the rank's device."""
    n = buffers.alive.shape[0]
    if n % mesh.world:
        raise ValueError(f"capacity {n} is not a multiple of the "
                         f"{mesh.world} ranks")
    per = n // mesh.world
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    dev = mesh.device
    # copies: the step and densify write the slab in place
    tensors = {k: x[rows].to(dev, copy=True)
               for k, x in _anchor_tensors(params, buffers, adam).items()}
    params, buffers, adam = _with_anchor_tensors(params, buffers, adam,
                                                 tensors)
    params = params._replace(
        mlps=params.mlps.to(dev),
        prior=None if params.prior is None else type(params.prior)(
            *(tuple(x.to(dev) for x in f) for f in params.prior)))
    buffers = buffers._replace(bound_min=buffers.bound_min.to(dev),
                               bound_max=buffers.bound_max.to(dev))
    anchor = set(ANCHOR_FIELDS)

    def put(moments):
        return {k: x if k in anchor else x.to(dev) for k, x in
                moments.items()}

    return params, buffers, AdamState(mu=put(adam.mu), nu=put(adam.nu),
                                      count=adam.count)


def _band(height: int, world: int, rank: int):
    """(first tile row, tile rows) of `rank`'s band, and the padded height:
    every band has the same number of rows."""
    tiles_y = (height + rz.TILE - 1) // rz.TILE
    rows_per = -(-tiles_y // world)
    return rank * rows_per, rows_per, rows_per * world * rz.TILE


def make_sharded_train_step(cfg: TrainConfig, mesh: Comm, width: int,
                            height: int, phase: str, spatial_lr_scale: float,
                            level_scales=(), voxel_size: float = 0.0):
    """The sharded step of one (phase, resolution), the counterpart of
    `train.step.make_train_step` on a rank's slab:
    `step(params, buffers, adam, cam, gt_image, bg, it, with_stats,
    generator=None, draws=None) -> (params, buffers, adam, metrics)`.
    `gt_image` is the full [3,H,W] target; `draws` (a `ContextDraws` of the
    slab) replace the generator's in the context phase. The metrics are
    global."""
    mcfg, opt = cfg.model, cfg.opt
    _check_phase(phase, mcfg, level_scales)
    level_scales = tuple(level_scales)
    k = mcfg.n_offsets
    row0, rows_per, height_pad = _band(height, mesh.world, mesh.rank)
    y0, band_h = row0 * rz.TILE, rows_per * rz.TILE
    n_pix_total = float(width * height)

    def step(params: Params, buffers: Buffers, adam: AdamState, cam: dict,
             gt_image: torch.Tensor, bg: torch.Tensor, it: int,
             with_stats: bool, generator: torch.Generator | None = None,
             draws=None):
        dev = params.anchor.device
        cam = camera_tensors(cam, dev)
        maps = None
        if phase == "context":
            maps = kept_level_maps(params, buffers, mcfg, voxel_size,
                                   level_scales)
        p, leaves = _grad_leaves(params)
        names = list(leaves)
        net_names = [n for n in names if n not in ANCHOR_FIELDS]
        nk = params.offsets.shape[0] * k
        screen_dummy = torch.zeros((nk, 2), dtype=torch.float32, device=dev,
                                   requires_grad=True)

        inputs = phase_inputs(p, buffers, mcfg, opt, generator, phase=phase,
                              training=True, maps=maps, draws=draws)
        vis = rz.visible_filter(
            inputs.anchor_q.detach(), inputs.grid_scaling[:, :3].detach(),
            cam["world_view"], cam["full_proj"], cam["tanfovx"],
            cam["tanfovy"], width, height, valid=buffers.alive)
        index = torch.nonzero(vis).squeeze(1)
        slots = (index[:, None] * k + torch.arange(k, device=dev)).reshape(-1)
        ng, aux = generate_neural_gaussians(
            p, buffers, mcfg, opt, cam["camera_center"], vis, phase=phase,
            training=True, anchor_index=index, inputs=inputs)
        gv = ng.gauss_valid
        alive = buffers.alive

        # global counts: gaussians decoded, valid and alive anchors a rank
        m = slots.numel()
        counts = mesh.all_gather(torch.stack([
            torch.tensor(m, device=dev), gv.sum(), alive.sum()])
            .to(torch.int64)[None]).cpu()
        m_max = max(int(counts[:, 0].max()), 1)
        gv_total, alive_total = (int(x) for x in counts[:, 1:].sum(0))

        # the splat state, padded to the largest rank's count, gathered
        packed = torch.cat([ng.xyz, ng.scaling, ng.rot, ng.color,
                            ng.opacity[:, None], screen_dummy[slots],
                            gv[:, None].to(torch.float32)], 1)
        packed = torch.nn.functional.pad(packed, (0, 0, 0, m_max - m))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0, b0 = time.perf_counter(), mesh.gather_bytes
        full = mesh.all_gather(packed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mesh.splat_log.append((mesh.gather_bytes - b0,
                               (time.perf_counter() - t0) * 1e3))
        xyz, scaling, rot, color, opac, sd_all, gvalid = torch.split(
            full, SPLAT, 1)
        out = rz.rasterize(
            xyz, scaling, rot, color, opac[:, 0],
            world_view=cam["world_view"], full_proj=cam["full_proj"],
            tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"], width=width,
            height=height, bg=bg.to(dev), valid=gvalid[:, 0] > 0.5,
            screen_dummy=sd_all, tile_band=(row0, rows_per))
        # full-image visibility of the local gaussians: a gaussian is
        # visible if it touches a tile of any band
        vis_local = mesh.psum_scatter(out.visibility.to(torch.int32))[:m] > 0

        gt_band = torch.nn.functional.pad(
            gt_image, (0, 0, 0, height_pad - height))[:, y0:y0 + band_h]
        pix_valid = (torch.arange(y0, y0 + band_h, device=dev)
                     < height).to(torch.float32)[None, :, None]
        band = out.image
        diff = torch.abs(band - gt_band) * pix_valid
        l1 = diff.sum() / (3.0 * n_pix_total)
        # band-local SSIM, pixel-weighted (its window does not cross seams)
        w_band = float(pix_valid.sum()) * width / n_pix_total
        ssim_band = ssim(band * pix_valid, gt_band * pix_valid)
        sc = ng.scaling
        prod3 = sc[:, 0] * sc[:, 1] * sc[:, 2]
        scaling_reg = torch.where(gv, prod3, 0.0).sum() / max(gv_total, 1)
        # this rank's share of the loss; the shares sum to the loss
        loss = (opt.lmbda_rec * ((1.0 - opt.lambda_dssim) * l1
                                 + opt.lambda_dssim
                                 * (w_band - ssim_band * w_band))
                + opt.scaling_reg_weight * scaling_reg)
        bpp = torch.zeros((), device=dev)
        if phase == "context":
            bpp = aux.rate.bit_per_param / mesh.world
            mask_mean = ((torch.sigmoid(p.mask_logit) * alive[:, None]).sum()
                         / max(alive_total * k, 1))
            loss = loss + opt.lmbda * bpp + opt.mask_reg_weight * mask_mean

        grads = torch.autograd.grad(loss, [leaves[n] for n in names]
                                    + [screen_dummy], allow_unused=True)
        screen_grad = grads[-1]
        grads = dict(zip(names, grads[:-1]))
        # the replicated leaves' gradients, summed over ranks once
        net = [grads[n] if grads[n] is not None
               else torch.zeros_like(leaves[n]) for n in net_names]
        summed = mesh.psum(torch.cat([g.reshape(-1) for g in net]))
        for n, g in zip(net_names, torch.split(summed,
                                               [g.numel() for g in net])):
            grads[n] = g.view_as(leaves[n])
        grads = {n: g for n, g in grads.items() if g is not None}

        if with_stats:
            def to_slots(x):
                return x.new_zeros((nk,) + x.shape[1:]).index_copy(0, slots,
                                                                   x)
            buffers = accumulate_stats(
                buffers, to_slots(ng.neural_opacity.detach()), to_slots(gv),
                to_slots(vis_local), vis,
                torch.zeros_like(screen_dummy) if screen_grad is None
                else screen_grad, k)

        params, adam = adam_update(params, grads, adam, opt, it,
                                   spatial_lr_scale)
        with torch.no_grad():
            sums = mesh.psum(torch.stack([
                loss.detach(), l1.detach(), (diff * diff).sum().detach(),
                bpp.detach()]).to(torch.float64)).cpu()
            mse = float(sums[2]) / (3.0 * n_pix_total)
            metrics = StepMetrics(
                loss=sums[0].to(torch.float32), l1=sums[1].to(torch.float32),
                psnr=torch.tensor(-10.0 * np.log10(max(mse, 1e-12)),
                                  dtype=torch.float32),
                bit_per_param=sums[3].to(torch.float32),
                n_visible_gauss=torch.tensor(gv_total), overflowed=False,
                vis_overflowed=False, n_instances=out.n_instances,
                n_vis=out.n_vis)
        return params, buffers, adam, metrics

    return step


def make_sharded_densify(cfg: TrainConfig, mesh: Comm, voxel_size: float):
    """`adjust_anchors` on a rank's slab: growth takes the slab's own free
    slots, candidate voxels are deduplicated against every rank's anchors.
    `run(params, buffers, adam, generator=None, draws=None)` →
    `DensifyResult` whose counts and overflow are global."""

    def run(params, buffers, adam, generator=None, draws=None):
        res = adjust_anchors(params, buffers, adam, cfg.model, cfg.opt,
                             voxel_size, generator, group=mesh, draws=draws)
        tot = mesh.psum(torch.stack([
            res.n_grown.to(torch.int64), res.n_pruned.to(torch.int64),
            res.overflowed.to(torch.int64)]))
        return res._replace(n_grown=tot[0], n_pruned=tot[1],
                            overflowed=tot[2] > 0)

    return run


def compute_tree_roots(anchor: np.ndarray, alive: np.ndarray,
                       voxel_size: float, level_scales: tuple,
                       level_num: int) -> np.ndarray:
    """[N] int32: each anchor's coarsest-level ancestor (host side).

    The hierarchy is a forest: the members of a voxel at any level share
    their representative, so voxels never span trees, and sharding whole
    trees keeps every parent gather on one shard."""
    maps = build_level_maps(
        torch.from_numpy(np.array(anchor, np.float32)),
        torch.from_numpy(np.array(alive, bool)), float(voxel_size),
        tuple(level_scales), int(level_num))
    parent = maps.parent.numpy()
    root = np.arange(anchor.shape[0], dtype=np.int64)
    for _ in range(level_num - 1):
        root = parent[root]
    return root.astype(np.int32)


def reshard_rows(params: Params, buffers: Buffers, n_dev: int,
                 voxel_size: float, level_scales: tuple | None = None,
                 level_num: int = 3, headroom: float = 1.3,
                 min_capacity: int = 0):
    """The row plan of `reshard_anchors`: (src, info), where `src[j]` is
    the old row of new row j (-1: a dead pad slot), so that a per-slot
    quantity (a densify draw) can follow the anchors."""
    alive = buffers.alive.cpu().numpy().copy()
    n = alive.shape[0]

    # voxels and trees are keyed off the 16-bit quantized anchor, the grid
    # the training step and densify use
    bmin = buffers.bound_min.cpu().numpy()
    bmax = buffers.bound_max.cpu().numpy()
    interval = (bmax - bmin) * Q_ANCHOR + 1e-6
    codes = np.clip(np.floor((params.anchor.detach().cpu().numpy() - bmin)
                             / interval), 0, 2 ** ANCHOR_ROUND_DIGITS - 1)
    anchor = codes * interval + bmin

    keys = np.round(anchor / voxel_size).astype(np.int64)
    ai = np.nonzero(alive)[0]
    _, first = np.unique(keys[ai], axis=0, return_index=True)
    keep = ai[np.sort(first)]
    n_dupes = len(ai) - len(keep)

    if level_scales:
        # colocate by the kept set's trees (alive ∧ mask_anchor), the
        # forest the training step's level maps are built over
        mask_np = st.get_mask_anchor(params._replace(
            mask_logit=params.mask_logit.detach().cpu()),
            torch.from_numpy(alive)).numpy()
        root = compute_tree_roots(anchor, mask_np, voxel_size, level_scales,
                                  level_num)[keep].astype(np.int64)
        shard = ((root * 2654435761) % 2 ** 31) % n_dev
    else:
        ck = np.floor(anchor[keep] / (voxel_size * 16.0)).astype(np.int64)
        shard = (((ck[:, 0] * 73856093) ^ (ck[:, 1] * 19349663)
                  ^ (ck[:, 2] * 83492791)) % (2 ** 31)) % n_dev

    per = [keep[shard == d] for d in range(n_dev)]
    need = max(len(p) for p in per)
    cap_per = max(n // n_dev, 1)
    if need > cap_per or need * headroom > cap_per:
        cap_per = int(np.ceil(need * headroom / 256.0) * 256)
    cap_per = max(cap_per, -(-min_capacity // n_dev))
    new_n = cap_per * n_dev

    src = np.full(new_n, -1, np.int64)
    for d, rows in enumerate(per):
        src[d * cap_per:d * cap_per + len(rows)] = rows
    return src, dict(n_alive=int(len(keep)), n_dupes_removed=int(n_dupes),
                     capacity=int(new_n))


def reshard_anchors(params: Params, buffers: Buffers, adam: AdamState,
                    n_dev: int, voxel_size: float,
                    level_scales: tuple | None = None, level_num: int = 3,
                    headroom: float = 1.3, min_capacity: int = 0):
    """Host-side anchor redistribution, at densify cadence:

    1. global voxel dedup at the finest anchor grid (ranks can grow the
       same voxel within one interval; the first occupant stays);
    2. shard assignment: a hash of the anchor's context-tree root once the
       level scales are known (each tree on one shard), a spatial voxel
       hash before that;
    3. packing into equal-capacity slabs (grown when a shard outgrows its
       slab, or to `min_capacity`), dead tail slots zeroed.

    The anchor-indexed tensors of the full state come in and go out on the
    host, with the reference's arithmetic and hashes; the replicated parts
    pass through. Returns (params, buffers, adam, info); the capacity is a
    multiple of n_dev, so `shard_model` slabs it."""
    src, info = reshard_rows(params, buffers, n_dev, voxel_size,
                             level_scales, level_num, headroom, min_capacity)
    return (*take_rows(params, buffers, adam, src), info)


def take_rows(params: Params, buffers: Buffers, adam: AdamState,
              src: np.ndarray):
    """The full state's anchor-indexed tensors moved on the host by the row
    plan `src` of `reshard_rows` (pad rows dead and zeroed); the replicated
    parts pass through. → (params, buffers, adam)."""
    pad = torch.from_numpy(src < 0)
    src_c = torch.from_numpy(np.where(src < 0, 0, src))

    def take(x):
        out = x.detach().cpu()[src_c]
        out[pad] = 0
        return out

    tensors = {name: take(x) for name, x in
               _anchor_tensors(params, buffers, adam).items()}
    tensors["b.alive"] = ~pad
    params, buffers, adam = _with_anchor_tensors(params, buffers, adam,
                                                 tensors)
    buffers = buffers._replace(bound_min=buffers.bound_min.cpu(),
                               bound_max=buffers.bound_max.cpu())
    return params, buffers, adam


def net_state(params: Params) -> dict:
    """The replicated leaves of `params` on the host, by name."""
    return {name: x.detach().cpu().clone()
            for name, x in st.param_leaves(params).items()
            if name not in ANCHOR_FIELDS}


def _on(x, dev):
    """A per-rank draw (a tensor, or a NamedTuple of tensors and tuples of
    tensors) onto `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return type(x)(*(tuple(t.to(dev) for t in f) if isinstance(f, tuple)
                     else None if f is None else f.to(dev) for f in x))


def run_steps(mesh: Comm, job: dict) -> dict:
    """Rank body that runs sharded steps, densify rounds and reshards from
    a given full state: the way `tests/test_torch_sharded.py` holds the
    sharded step and densify to the JAX package's and to the
    single-process port.

    job: cfg; params, buffers, adam (the full state on the host, slabbed as
    it is: rank r takes rows [r·n/R, (r+1)·n/R)); width, height, phase,
    level_scales, voxel_size, spatial_lr_scale; cam, gt (numpy [3,H,W]),
    bg; seed; and `actions`, each a dict of `kind` "step" (it, with_stats,
    draws: per rank or None), "densify" (draws: per rank or None) or
    "reshard". → on the host: this rank's slab after every action
    (`slabs`), the replicated leaves, the steps' metrics and the densify
    rounds' global counts."""
    cfg = job["cfg"]
    dev = mesh.device
    sp, sb, sa = shard_model(mesh, job["params"], job["buffers"], job["adam"])
    gen = torch.Generator(dev).manual_seed(job.get("seed", 0) * 1000
                                           + mesh.rank)
    step = make_sharded_train_step(
        cfg, mesh, job["width"], job["height"], job["phase"],
        job["spatial_lr_scale"], job["level_scales"], job["voxel_size"])
    densify = make_sharded_densify(cfg, mesh, job["voxel_size"])
    gt = torch.from_numpy(np.asarray(job["gt"], np.float32)).to(dev)
    bg = torch.as_tensor(job["bg"], dtype=torch.float32, device=dev)
    out = dict(slabs=[], metrics=[], densify=[])
    for act in job["actions"]:
        draws = act.get("draws")
        draws = None if draws is None else _on(draws[mesh.rank], dev)
        if act["kind"] == "step":
            sp, sb, sa, m = step(sp, sb, sa, job["cam"], gt, bg, act["it"],
                                 act["with_stats"], gen, draws)
            out["metrics"].append(dict(
                loss=float(m.loss), l1=float(m.l1), psnr=float(m.psnr),
                bit_per_param=float(m.bit_per_param)))
        elif act["kind"] == "densify":
            res = densify(sp, sb, sa, gen, draws)
            sp, sb, sa = res.params, res.buffers, res.adam
            out["densify"].append(dict(n_grown=int(res.n_grown),
                                       n_pruned=int(res.n_pruned),
                                       overflowed=bool(res.overflowed)))
        else:
            hp, hb, ha, _ = reshard_anchors(
                *gather_model(mesh, sp, sb, sa), mesh.world,
                job["voxel_size"], level_scales=tuple(job["level_scales"]),
                level_num=cfg.model.level_num)
            sp, sb, sa = shard_model(mesh, hp, hb, ha)
        out["slabs"].append({k: x.detach().cpu().clone() for k, x in
                             _anchor_tensors(sp, sb, sa).items()})
    out["net"] = net_state(sp)
    return out
