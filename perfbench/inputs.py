"""The cells' inputs, made by the harness from `--seed` and never by the
program: the synthetic scene state, the MLP and prior weights, the orbit
cameras and the training targets.

The per-anchor arrays are drawn on the device from one `torch.Generator`,
a few large calls each; the MLPs and the factorized prior are small and are
drawn on the host from a CPU generator. The scene recipe is that of the
decoded scene `contextgs_tpu_torch/scripts/fps_bench.py` serves (anchors
uniform in [-extent, extent]³, features and offsets normal, scaling
uniform, a share of the offsets kept), with the sizes in the configuration
file. Every seed gets the same sizes; only the draws differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import model as md
from perfbench.reference import raster
from perfbench.reference.codec import coding_context, level_chain

# mask logits of kept and dropped offsets: sigmoid 0.88 and 0.0025, on either
# side of the 0.01 threshold of the offset masks
KEPT_LOGIT, DROPPED_LOGIT = 2.0, -6.0
STREAMS = {"anchors": 1, "mlps": 2, "targets": 3, "order": 4, "coded": 5}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of one stream of draws of `seed`."""
    return (int(seed) * 1_000_003 + STREAMS[stream]) % (1 << 63)


def model_config(config: dict) -> md.Model:
    """The reference's model sizes of a configuration file."""
    return md.Model.of(config)


def anchor_state(config: dict, seed: int, device) -> dict:
    """The scene's per-anchor tensors on `device` by the names of the
    program's `Params` and `Buffers` (every slot alive, the quantization
    bounds from the anchors, the densification statistics zero)."""
    mcfg = model_config(config)
    n, f, k = config["anchors"], mcfg.feat_dim, mcfg.n_offsets
    g = torch.Generator(device).manual_seed(stream_seed(seed, "anchors"))
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    lo, hi = config["scaling_range"]
    ext = config["extent"]
    anchor = torch.rand((n, 3), **f32) * (2 * ext) - ext
    state = dict(
        anchor=anchor,
        anchor_feat=torch.randn((n, f), **f32) * config["feat_std"],
        hyper_latent=torch.randn((n, mcfg.hyper_dim), **f32)
        * config["hyper_std"],
        offsets=torch.randn((n, k, 3), **f32) * config["offset_std"],
        mask_logit=torch.where(torch.rand((n, k), **f32)
                               < config["mask_keep"], KEPT_LOGIT,
                               DROPPED_LOGIT),
        scaling_log=torch.log(torch.rand((n, 6), **f32) * (hi - lo) + lo),
        rotation=torch.tensor([1.0, 0.0, 0.0, 0.0],
                              device=device).repeat(n, 1),
        opacity_raw=torch.full((n, 1), math.log(0.1 / 0.9),
                               dtype=torch.float32, device=device),
    )
    alive = torch.ones(n, dtype=torch.bool, device=device)
    bmin, bmax = md.anchor_bounds(anchor, alive)
    zeros = dict(dtype=torch.float32, device=device)
    state.update(alive=alive, bound_min=bmin, bound_max=bmax,
                 opacity_accum=torch.zeros(n, **zeros),
                 anchor_denom=torch.zeros(n, **zeros),
                 offset_grad_accum=torch.zeros((n, k), **zeros),
                 offset_denom=torch.zeros((n, k), **zeros))
    return state


def net_weights(config: dict) -> dict:
    """The decoder and grid MLPs' weights by module path (`mlps.<path>`)
    and the factorized prior's tensors (`prior.<field>.<i>`), on the host:
    the names of `state.param_leaves`. They are the configuration's model,
    drawn from its `weights_seed`, the same for every `--seed`: random
    networks of different draws keep different shares of the gaussians
    (the opacity MLP's sign) and so change the work from seed to seed."""
    gen = torch.Generator().manual_seed(stream_seed(config["weights_seed"],
                                                    "mlps"))
    return md.init_nets(model_config(config), gen)


def level_scales(state: dict, config: dict) -> list:
    """The per-level voxel scales of the kept anchors, searched on the host
    as the training loop searches them at its context transition."""
    kept = (torch.sigmoid(state["mask_logit"]) > 0.01).any(1) & state["alive"]
    return md.find_level_scales(
        state["anchor"][kept].cpu().numpy(), config["voxel_size"],
        state["bound_min"].cpu().numpy(), state["bound_max"].cpu().numpy(),
        config["target_ratio"], config["level_num"])


def orbit_poses(traffic: dict, width: int, height: int) -> list:
    """(R, T, fov_x, fov_y) of `views` cameras evenly spaced about the y
    axis at distance `radius`, looking at the origin."""
    views = traffic["views"]
    fov_x = traffic["fov_x"]
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * height / width)
    poses = []
    for i in range(views):
        ang = 2 * np.pi * i / views
        rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]])
        poses.append((rot, np.array([0.0, 0.0, traffic["radius"]]), fov_x,
                      fov_y))
    return poses


def reference_cameras(traffic: dict, width: int, height: int,
                      device) -> list:
    """The orbit as the reference's cameras (`raster.camera`)."""
    return [raster.camera(r, t, fx, fy, device)
            for r, t, fx, fy in orbit_poses(traffic, width, height)]


def targets(traffic: dict, width: int, height: int, seed: int,
            device) -> np.ndarray:
    """[views, H, W, 3] float32 training targets, uniform in [0, 1), drawn
    on the device and handed over on the host, where the training loop
    takes its images from."""
    g = torch.Generator(device).manual_seed(stream_seed(seed, "targets"))
    return torch.rand((traffic["views"], height, width, 3), generator=g,
                      dtype=torch.float32, device=device).cpu().numpy()


def view_order(views: int, seed: int) -> list:
    """Every view of the orbit once, from a seeded start, walking round."""
    start = int(np.random.default_rng(stream_seed(seed, "order"))
                .integers(views))
    return [(start + i) % views for i in range(views)]


def coded_state(state: dict, nets: dict, config: dict, level_scales,
                seed: int, device) -> None:
    """Make `state` and `nets` (in place) a scene whose codec residuals are
    those of a trained one: the grid MLPs' scaling means sit near
    `coded.scaling_mean` (their weights scaled by `coded.scaling_weight`),
    and level by level from the coarsest the kept anchors' features,
    scalings and offsets are drawn around the entropy model's own predicted
    means, `coded.residual_steps` steps of Q apart at one standard
    deviation. Random MLPs alone predict means hundreds of steps from a
    random scene's values, which would make every chunk take the codec's
    widest window."""
    coded = config["coded"]
    mcfg = model_config(config)
    f, k = mcfg.feat_dim, mcfg.n_offsets
    for i in range(mcfg.level_num):
        rows = slice(2 * f, 2 * f + 6)        # the grid's scaling means
        nets[f"mlps.grid.{i}.l2.weight"][rows] *= coded["scaling_weight"]
        nets[f"mlps.grid.{i}.l2.bias"][rows] = coded["scaling_mean"]
    m = dict(state)
    m.update({name: x.to(device) for name, x in nets.items()})
    ctx = coding_context(m, mcfg, level_scales, device)
    rng = np.random.default_rng(stream_seed(seed, "coded"))
    new = {s: np.zeros((ctx["n"], w), np.float32)
           for s, w in md.stream_widths(mcfg).items()}

    def values(rows, predicted):
        out = {}
        for s, (mean, q) in predicted.items():
            x = mean + coded["residual_steps"] * q * rng.standard_normal(
                mean.shape).astype(np.float32)
            if s == "scaling":
                x = np.maximum(x, q)
            new[s][rows] = out[s] = x
        return out

    for _ in level_chain(ctx, m, mcfg, device, values):
        pass
    idx = ctx["idx"]
    with torch.no_grad():
        state["anchor_feat"][idx] = torch.from_numpy(new["feat"]).to(device)
        state["scaling_log"][idx] = torch.log(
            torch.from_numpy(new["scaling"]).to(device))
        state["offsets"][idx] = torch.from_numpy(new["offsets"]).to(
            device).reshape(-1, k, 3)
