"""ContextGS's steps that grow anchors under quantization, in the plain
reference: the noise phase's steps (steps 3001–10000) and the context
phase's (10001–15000), each with the densification statistics, then the
round (`densify.adjust_anchors`) and the level hierarchy of the grown pool
(`model.build_levels`), composed from `model.py`, `train.py` and
`densify.py` and written from ContextGS's semantics (`train.py`,
`gaussian_renderer/__init__.py`, `scene/gaussian_model.py`), as the JAX
package of this repository states them, in plain float32 PyTorch.

A step renders the view from the anchors as its phase quantizes them:

- noise: the features, the scalings and the offsets each plus (u − ½)·Q
  at its base Q (1, 0.001, 0.2), u a U[0,1) draw of every element;
- context: the level hierarchy built anew over the kept anchors, each
  anchor's features, scalings and offsets quantized at its own level with
  the Q, μ and σ of that level's grid MLP (`model.context`), and the rate
  and mask terms added to the loss (`train.loss_of`'s);

then takes the loss, each leaf's gradient, the statistics from the
screen-space gradient (`densify.accumulate`) and Adam, as
`densify.follow_plain` does.

Departures from ContextGS's code, each as the JAX package states it, beside
those `densify.py` and `train.py` note:

- the draws come as an argument, a dict a step (the keys of
  `model.draw_noise`; in the noise phase "feat", "scaling" and
  "offsets"), so that the reference can be handed the program's own;
  ContextGS draws `uniform_(-0.5, 0.5)` noise in place, and in the noise
  phase draws it for the visible anchors only;
- the level hierarchy is built every step over the kept anchors (alive,
  one offset on) of the quantized anchors, so that anchors grown since the
  last step are coded at their own level; the anchors are quantized with
  the bounds of the context transition, as ContextGS's `get_anchor` does
  until the next transition (anchors outside them are clamped to the
  first or the last code);
- the views of the steps come as a list, not from the run's permutation.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as md
from perfbench.reference import raster
from perfbench.reference.densify import (STATS, accumulate, alive_rows,
                                         plain_loss)
from perfbench.reference.train import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                       LAMBDA_RATE, MASK_REG, RATE_SAMPLE,
                                       learning_rate, param_names, precision)

NOISE_STREAMS = ("feat", "scaling", "offsets")


def draw(generator, n: int, model: md.Model, phase: str, device) -> dict:
    """One step's U[0,1) draws for `n` rows, in the order the step takes
    them: the noise phase's features [n,F], scalings [n,6] and offsets
    [n,K,3]; the context phase's `model.draw_noise`."""
    if phase == "context":
        return md.draw_noise(generator, n, model, device)
    shapes = dict(feat=(n, model.feat_dim), scaling=(n, 6),
                  offsets=(n, model.n_offsets, 3))
    return {s: torch.rand(shapes[s], generator=generator,
                          dtype=torch.float32, device=device)
            for s in NOISE_STREAMS}


def rows_of(draws: dict, rows: torch.Tensor) -> dict:
    """The draws of the rows `rows` (a mask or an index) of each."""
    return {k: v[rows] for k, v in draws.items()}


def pool_levels(rows: dict, model: md.Model, level_scales) -> md.Levels:
    """The level and parent of every row of `rows` (a pool: the anchor
    fields, `alive` and the bounds), built over its kept anchors from the
    quantized anchors."""
    return md.build_levels(md.quantized_anchor(rows).detach(),
                           md.kept_anchors(rows), model.voxel_size,
                           level_scales, model.level_num)


def render(m: dict, model: md.Model, phase: str, cam: dict, width: int,
           height: int, bg: torch.Tensor, screen: torch.Tensor, u: dict,
           level_scales) -> tuple:
    """(image [3,H,W], gaussians, visible anchors [N], touches a tile
    [N·K], bits a parameter or None) of a step of `phase` on the draws
    `u`. `screen` [N·K,2] (zero) is added to the 2D means in normalised
    device coordinates, as in `densify.render`."""
    n = m["anchor"].shape[0]
    anchor_q = md.quantized_anchor(m)
    scaling = torch.exp(m["scaling_log"])
    vis = raster.visible(anchor_q.detach(), scaling[:, :3].detach(), cam,
                         width, height, valid=m["alive"]) & m["alive"]
    bits = None
    if phase == "noise":
        feat = m["anchor_feat"] + (u["feat"] - 0.5) * model.q_feat
        grid_scaling = scaling + (u["scaling"] - 0.5) * model.q_scaling
        offsets = m["offsets"] + (u["offsets"] - 0.5) * model.q_offsets
    else:
        levels = md.build_levels(anchor_q.detach(), md.kept_anchors(m),
                                 model.voxel_size, level_scales,
                                 model.level_num)
        ctx = md.context(m, model, levels, anchor_q, u)
        bits = md.rate(m, model, ctx, u["rate"], RATE_SAMPLE)
        feat, grid_scaling = ctx.coded["feat"], ctx.coded["scaling"]
        offsets = ctx.coded["offsets"]
    g = md.neural_gaussians(m, model, cam["center"], vis, feat, grid_scaling,
                            offsets.reshape(n, -1, 3), anchor_q,
                            md.offset_mask(m))
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
    image = rgb + final_t[None] * bg[:, None, None]
    return image, g, vis, s.keep, bits


def step_loss(m: dict, model: md.Model, image, gt, g, bits) -> torch.Tensor:
    """The plain phase's loss, plus in the context phase λ·bits a
    parameter and 5e-4·the alive anchors' mean sigmoid(mask logit)."""
    loss = plain_loss(image, gt, g)
    if bits is None:
        return loss
    alive = m["alive"].to(torch.float32)[:, None]
    mask_mean = ((torch.sigmoid(m["mask_logit"]) * alive).sum()
                 / torch.clamp(alive.sum() * model.n_offsets, min=1))
    return loss + LAMBDA_RATE * bits + MASK_REG * mask_mean


def follow(state: dict, nets: dict, model: md.Model, phase: str,
           cameras: list, images: np.ndarray, views: list, draws: list,
           level_scales, spatial_lr_scale: float, start_iteration: int,
           device, tf32: bool = False) -> dict:
    """{"loss": [per step], "grad": {leaf: norm of its first gradient},
    "change": {leaf: norm of its change after the steps}, "stats": {name:
    the anchors' statistics after them}} of one step a view of `views`,
    in `phase`, resumed at `start_iteration` with fresh Adam moments from
    the alive anchors of the pooled `state`; step k takes the draws
    `draws[k]` of those anchors."""
    m = alive_rows(state)
    m.update({k: v.to(device).clone() for k, v in nets.items()})
    names = param_names(m)
    start = {n: m[n].clone() for n in names}
    mom = {n: torch.zeros_like(m[n]) for n in names}
    vel = {n: torch.zeros_like(m[n]) for n in names}
    stats = {s: m[s] for s in STATS}
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    height, width = images.shape[1:3]
    nk = m["anchor"].shape[0] * model.n_offsets
    out = {"loss": [], "grad": {}, "change": {}}
    with precision(tf32):
        for k, (v, u) in enumerate(zip(views, draws), 1):
            it = start_iteration + k
            gt = torch.from_numpy(np.ascontiguousarray(
                np.transpose(images[v], (2, 0, 1)))).to(device)
            leaves = {n: m[n].detach().requires_grad_(True) for n in names}
            screen = torch.zeros((nk, 2), dtype=torch.float32, device=device,
                                 requires_grad=True)
            rows = {**m, **leaves}
            image, g, vis, keep, bits = render(rows, model, phase,
                                               cameras[v], width, height, bg,
                                               screen, u, level_scales)
            loss = step_loss(rows, model, image, gt, g, bits)
            grads = torch.autograd.grad(
                loss, [leaves[n] for n in names] + [screen],
                allow_unused=True)
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                stats = accumulate(stats, g, vis, keep, grads[-1],
                                   model.n_offsets)
            del image, g, bits, loss
            with torch.no_grad():
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
