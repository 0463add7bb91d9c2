"""ContextGS's anchor-growing phase in the plain reference: the plain phase's
training step with the densification statistics, and the densification
round, written from Scaffold-GS's and ContextGS's semantics
(`scene/gaussian_model.py`: `training_statis`, `anchor_growing`,
`adjust_anchor`; `train.py`'s plain-phase loss), as the JAX package of this
repository states them, in plain float32 PyTorch.

The round works as ContextGS writes it: every row of the state is an
anchor, new anchors are concatenated after the others, voxels are
deduplicated by `torch.unique(dim=0)` and tested for occupancy by set
membership, a new anchor takes the largest feature and hyper latent of the
candidates in its voxel (`scatter_max`), its Adam moments and statistics
are zero, and pruned anchors are removed.

Departures from the published description, each as the JAX package
states it:

- the anchors are the 16-bit quantized ones (`get_anchor`), with the
  bounds of the round's start, in the step and in the round;
- every depth of a round runs; ContextGS skips the depths after the first
  when no anchor has been grown yet in the round;
- a new anchor's raw opacity is the log of 0.1/0.9 rounded once to
  float32, where ContextGS takes `inverse_sigmoid(0.1)` in float32 (the
  field is frozen and never rendered);
- the gaussians' log-scales (the last three of each anchor's six) are
  clamped at 0.05 at the end of every round;
- the keep draws come as an argument, one row a depth over the offsets of
  the anchors present when the round starts, where ContextGS draws
  `torch.rand_like` at each depth; so the reference can be handed the
  program's draws.

Divisions by a voxel size divide by a float32 tensor on the data's device,
not by a Python number (which a CUDA division would turn into a product by
its reciprocal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference import model as md
from perfbench.reference import raster
from perfbench.reference.train import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                       LAMBDA_DSSIM, SCALING_REG,
                                       learning_rate, param_names, precision,
                                       ssim)

STATS = ("opacity_accum", "anchor_denom", "offset_grad_accum",
         "offset_denom")


@dataclass(frozen=True)
class Schedule:
    """The densification settings of a configuration file."""

    start_stat: int
    update_from: int
    update_interval: int
    update_until: int
    densify_grad_threshold: float
    min_opacity: float
    success_threshold: float
    update_depth: int
    update_init_factor: int
    update_hierachy_factor: int

    @classmethod
    def of(cls, config: dict) -> "Schedule":
        return cls(**{k: config[k] for k in cls.__dataclass_fields__})


# -- the plain phase's step ----------------------------------------------

def render(m: dict, model: md.Model, cam: dict, width: int, height: int,
           bg: torch.Tensor, screen: torch.Tensor) -> tuple:
    """(image [3,H,W], gaussians, visible anchors [N], touches a tile
    [N·K]) of the plain phase: the raw features, scalings and offsets of
    the quantized anchors. `screen` [N·K,2] (zero) is added to the 2D
    means in normalised device coordinates, so its gradient is 3DGS's
    screen-space gradient."""
    n = m["anchor"].shape[0]
    anchor_q = md.quantized_anchor(m)
    scaling = torch.exp(m["scaling_log"])
    vis = raster.visible(anchor_q.detach(), scaling[:, :3].detach(), cam,
                         width, height, valid=m["alive"]) & m["alive"]
    g = md.neural_gaussians(m, model, cam["center"], vis, m["anchor_feat"],
                            scaling, m["offsets"].reshape(n, -1, 3),
                            anchor_q, md.offset_mask(m))
    s = raster.project(g.xyz, g.scaling, g.rot, cam, width, height,
                       valid=g.valid, opacities=g.opacity.detach())
    ndc = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                       device=anchor_q.device)
    ids, tile = raster.instances(s, width)
    n_tiles = -(-width // raster.TILE) * -(-height // raster.TILE)
    rgb, final_t = raster.blend(s.means2d + screen * ndc, s.conics,
                                g.opacity, g.color, ids,
                                raster.tile_bounds(tile, n_tiles), width,
                                height)
    return rgb + final_t[None] * bg[:, None, None], g, vis, s.keep


def plain_loss(image, gt, g) -> torch.Tensor:
    """(1 - λ)·L1 + λ·(1 - SSIM) + 0.01·mean volume of the valid
    gaussians."""
    sc = g.scaling
    volume = torch.where(g.valid, sc[:, 0] * sc[:, 1] * sc[:, 2], 0.0)
    return ((1 - LAMBDA_DSSIM) * (image - gt).abs().mean()
            + LAMBDA_DSSIM * (1 - ssim(image, gt))
            + SCALING_REG * volume.sum() / torch.clamp(g.valid.sum(), min=1))


def accumulate(stats: dict, g, vis: torch.Tensor, keep: torch.Tensor,
               screen_grad: torch.Tensor, k: int) -> dict:
    """`training_statis`: each visible anchor adds the sum of its
    gaussians' positive opacities and one visit; each gaussian that is
    valid and touches a tile adds the norm of its screen-space gradient
    and one visit."""
    n = vis.shape[0]
    update = (g.valid & keep).reshape(n, k)
    norm = torch.linalg.vector_norm(screen_grad[:, :2], dim=-1).reshape(n, k)
    return dict(
        opacity_accum=stats["opacity_accum"]
        + torch.where(vis, g.opacity.reshape(n, k).sum(1), 0.0),
        anchor_denom=stats["anchor_denom"] + vis.to(torch.float32),
        offset_grad_accum=stats["offset_grad_accum"]
        + torch.where(update, norm, 0.0),
        offset_denom=stats["offset_denom"] + update.to(torch.float32))


def alive_rows(state: dict) -> dict:
    """The anchors of a pooled state as rows (the alive slots, in order),
    with its bounds."""
    alive = state["alive"]
    out = {f: state[f][alive] for f in md.ANCHOR_FIELDS + STATS}
    out.update(alive=alive[alive], bound_min=state["bound_min"],
               bound_max=state["bound_max"])
    return out


def follow_plain(state: dict, nets: dict, model: md.Model, cameras: list,
                 images: np.ndarray, spatial_lr_scale: float,
                 rng_state: dict, start_iteration: int, steps: int, device,
                 tf32: bool = False) -> dict:
    """{"loss": [per step], "grad": {leaf: norm of its first gradient},
    "change": {leaf: norm of its change after the steps}, "stats": {name:
    the anchors' statistics after them}} of `steps` plain-phase steps
    resumed at `start_iteration` with fresh Adam moments and statistics
    from the state's, on its alive anchors; the views in the order a
    resumed run takes them (a permutation from `rng_state`, popped from
    its end)."""
    m = alive_rows(state)
    m.update({k: v.to(device).clone() for k, v in nets.items()})
    names = param_names(m)
    start = {n: m[n].clone() for n in names}
    mom = {n: torch.zeros_like(m[n]) for n in names}
    vel = {n: torch.zeros_like(m[n]) for n in names}
    stats = {s: m[s] for s in STATS}
    rng = np.random.default_rng(0)
    rng.bit_generator.state = rng_state
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    height, width = images.shape[1:3]
    nk = m["anchor"].shape[0] * model.n_offsets
    order: list = []
    out = {"loss": [], "grad": {}, "change": {}}
    with precision(tf32):
        for k in range(1, steps + 1):
            it = start_iteration + k
            if not order:
                order = [int(i) for i in rng.permutation(len(cameras))]
            v = order.pop()
            gt = torch.from_numpy(np.ascontiguousarray(
                np.transpose(images[v], (2, 0, 1)))).to(device)
            leaves = {n: m[n].detach().requires_grad_(True) for n in names}
            screen = torch.zeros((nk, 2), dtype=torch.float32, device=device,
                                 requires_grad=True)
            image, g, vis, keep = render({**m, **leaves}, model, cameras[v],
                                         width, height, bg, screen)
            loss = plain_loss(image, gt, g)
            grads = torch.autograd.grad(
                loss, [leaves[n] for n in names] + [screen],
                allow_unused=True)
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                stats = accumulate(stats, g, vis, keep, grads[-1],
                                   model.n_offsets)
                bc1, bc2 = 1 - ADAM_B1 ** k, 1 - ADAM_B2 ** k
                for n, gr in zip(names, grads[:-1]):
                    gr = torch.zeros_like(m[n]) if gr is None else gr
                    if k == 1:
                        out["grad"][n] = float(torch.linalg.vector_norm(
                            gr.double()))
                    mom[n] = ADAM_B1 * mom[n] + (1 - ADAM_B1) * gr
                    vel[n] = ADAM_B2 * vel[n] + (1 - ADAM_B2) * gr * gr
                    lr = learning_rate(n, it, spatial_lr_scale)
                    m[n] = m[n] - lr * (mom[n] / bc1) / (
                        torch.sqrt(vel[n] / bc2) + ADAM_EPS)
    out["change"] = {n: float(torch.linalg.vector_norm(
        (m[n] - start[n]).double())) for n in names}
    out["stats"] = stats
    return out


# -- the densification round ---------------------------------------------

def _occupied(keys: torch.Tensor, anchor_keys: torch.Tensor) -> torch.Tensor:
    """[len(keys)] bool: the row of `keys` is one of `anchor_keys`'s."""
    _, inv = torch.unique(torch.cat([anchor_keys, keys]), dim=0,
                          return_inverse=True)
    held = torch.zeros(int(inv.max()) + 1 if inv.numel() else 0,
                       dtype=torch.bool, device=keys.device)
    held[inv[:anchor_keys.shape[0]]] = True
    return held[inv[anchor_keys.shape[0]:]]


def adjust_anchors(m: dict, moments: dict, model: md.Model, sched: Schedule,
                   voxel_size: float, draws: torch.Tensor) -> dict:
    """One round, `adjust_anchor`: grow at `update_depth` voxel sizes,
    reset the consumed statistics, prune. `m` holds the anchor fields and
    the statistics, a row an anchor, and the bounds; `moments` {"mu":
    {field: rows}, "nu": {...}} Adam's moments of the anchor fields;
    `draws` [update_depth, rows·K] the keep draws. Returns {"m", "moments",
    "grown", "pruned"}, new tensors."""
    k = model.n_offsets
    dev = m["anchor"].device
    f32 = dict(dtype=torch.float32, device=dev)
    m = {n: v.clone() for n, v in m.items()}
    moments = {w: {f: v.clone() for f, v in part.items()}
               for w, part in moments.items()}
    n0 = m["anchor"].shape[0]
    grads = (m["offset_grad_accum"] / m["offset_denom"]).reshape(-1)
    grads = torch.where(torch.isnan(grads), 0.0, grads)
    offset_mask = (m["offset_denom"].reshape(-1)
                   > sched.update_interval * sched.success_threshold * 0.5)
    for i in range(sched.update_depth):
        thr = (sched.densify_grad_threshold
               * ((sched.update_hierachy_factor // 2) ** i))
        cand = ((grads >= thr) & offset_mask & (draws[i] > 0.5 ** (i + 1)))
        grown = m["anchor"].shape[0] - n0
        cand = torch.cat([cand, torch.zeros(grown * k, dtype=torch.bool,
                                            device=dev)])
        size = torch.full((), voxel_size * (
            sched.update_init_factor // sched.update_hierachy_factor ** i),
            **f32)
        anchor_q = md.quantized_anchor(m)
        scaling3 = torch.exp(m["scaling_log"])[:, :3]
        xyz = (anchor_q[:, None, :]
               + m["offsets"] * scaling3[:, None, :]).reshape(-1, 3)
        grid = torch.round(anchor_q / size).to(torch.int32)
        picked = torch.round(xyz[cand] / size).to(torch.int32)
        uniq, inv = torch.unique(picked, dim=0, return_inverse=True)
        new = ~_occupied(uniq, grid)
        n_new = int(new.sum())
        if n_new == 0:
            continue

        def voxel_max(field):
            rows = m[field].repeat_interleave(k, 0)[cand]
            out = torch.zeros((uniq.shape[0], rows.shape[1]), **f32)
            out = out.scatter_reduce(0, inv[:, None].expand_as(rows), rows,
                                     "amax", include_self=False)
            return out[new]

        add = dict(
            anchor=uniq[new].to(torch.float32) * size,
            anchor_feat=voxel_max("anchor_feat"),
            hyper_latent=voxel_max("hyper_latent"),
            offsets=torch.zeros((n_new, k, 3), **f32),
            mask_logit=torch.ones((n_new, k), **f32),
            scaling_log=torch.log(torch.ones((n_new, 6), **f32) * size),
            rotation=torch.zeros((n_new, 4), **f32),
            opacity_raw=torch.log(torch.full((n_new, 1), 0.1 / 0.9, **f32)))
        add["rotation"][:, 0] = 1.0
        for f, rows in add.items():
            m[f] = torch.cat([m[f], rows])
            for part in moments.values():
                part[f] = torch.cat([part[f], torch.zeros_like(rows)])
        for s in STATS:
            m[s] = torch.cat([m[s], torch.zeros((n_new,) + m[s].shape[1:],
                                                **f32)])
    n = m["anchor"].shape[0]
    consumed = torch.cat([offset_mask, torch.zeros((n - n0) * k,
                                                   dtype=torch.bool,
                                                   device=dev)]).reshape(n, k)
    m["offset_denom"] = torch.where(consumed, 0.0, m["offset_denom"])
    m["offset_grad_accum"] = torch.where(consumed, 0.0,
                                         m["offset_grad_accum"])
    enough = (m["anchor_denom"]
              > sched.update_interval * sched.success_threshold)
    prune = ((m["opacity_accum"] < sched.min_opacity * m["anchor_denom"])
             & enough)
    m["opacity_accum"] = torch.where(enough, 0.0, m["opacity_accum"])
    m["anchor_denom"] = torch.where(enough, 0.0, m["anchor_denom"])
    kept = ~prune
    for f in md.ANCHOR_FIELDS + STATS:
        m[f] = m[f][kept]
    for part in moments.values():
        for f in part:
            part[f] = part[f][kept]
    m["scaling_log"] = torch.cat([m["scaling_log"][:, :3], torch.clamp(
        m["scaling_log"][:, 3:], max=0.05)], dim=1)
    return {"m": m, "moments": moments, "grown": n - n0,
            "pruned": int(prune.sum())}
