"""Fly-in serving cells: one closed-loop viewer walking a closed multi-scale
path of look-at cameras round and round through
`evaluation.make_decoded_renderer`'s `render`, over a decoded city the
harness draws from the seed.

The city (the configuration's `city` keys) lies on the ground plane y = 0,
with y up: a `core_share` of the anchors uniform over a disc of
`core_radius` about the origin, the rest at a radius log-uniform in
[`core_radius`, `outer_radius`), each at a height uniform under the height
of its `block`-sized square of ground (exponential with mean
`height_mean`, capped at `height_cap`). Each anchor's six log-scales are
log(sqrt(d2)) of its mean squared distance d2 to its `knn` nearest anchors,
the rule by which the program seeds a scene from its points, plus a
uniform in [0, `scale_jitter`); a `voxel_size` of 0 takes the median d2,
the program's automatic voxel. Splats are small in the dense centre and
large on the sparse outskirts.

The path (the mix): `views` cameras aimed at the ground's centre at
`elevation_deg` above the ground, making `turns` turns of azimuth a lap;
the distance from the centre falls geometrically from `far` to `near`
over the first half of the lap and rises back over the second, so the lap
is closed. At the top nearly the whole city is in view, each splat under
a pixel; at street level a few percent of the anchors are left, each
splat over tens of tiles.

Timing, set-up, the window and the comparison with the plain reference
are `serve`'s (`kinds/serve.py`); the checked views are `fixed_views` (the
top and street level) and views drawn from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.spatial import cKDTree

from perfbench import inputs
from perfbench.harness import replaced
from perfbench.kinds import serve

FAULTS = serve.FAULTS
UP = np.array([0.0, 1.0, 0.0])


def mean_knn_sq_dist(points: np.ndarray, k: int) -> np.ndarray:
    """[N,3] → [N] float64 mean squared distance to the k nearest other
    points: the program's rule, computed here because the harness, not
    the program, makes the inputs."""
    d, _ = cKDTree(points).query(points, k=k + 1, workers=-1)
    return np.mean(d[:, 1:] ** 2, axis=1)


def city(config: dict, seed: int, device) -> tuple:
    """(state, voxel): the city's per-anchor tensors on `device` by the
    names of `inputs.anchor_state` that `serve.decoded_arrays` reads, and
    the voxel size (the configuration's, or where it is 0 or less the
    median d2)."""
    mcfg = inputs.model_config(config)
    c = config["city"]
    n, f, k = config["anchors"], mcfg.feat_dim, mcfg.n_offsets
    g = torch.Generator(device).manual_seed(inputs.stream_seed(seed,
                                                               "anchors"))
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    core = torch.arange(n, device=device) < round(n * c["core_share"])
    u = torch.rand(n, **f32)
    inner, outer = c["core_radius"], c["outer_radius"]
    radius = torch.where(core, inner * torch.sqrt(u),
                         inner * (outer / inner) ** u)
    angle = torch.rand(n, **f32) * (2 * math.pi)
    x, z = radius * torch.cos(angle), radius * torch.sin(angle)
    side = round(2 * outer / c["block"])
    block_h = torch.clamp(-c["height_mean"] * torch.log1p(
        -torch.rand(side * side, **f32)), max=c["height_cap"])

    def cell(v):
        return torch.clamp(((v + outer) / c["block"]).long(), 0, side - 1)

    y = block_h[cell(x) * side + cell(z)] * torch.rand(n, **f32)
    anchor = torch.stack([x, y, z], 1)
    d2 = mean_knn_sq_dist(anchor.cpu().numpy().astype(np.float64),
                          c["knn"])
    base = torch.from_numpy(np.log(np.sqrt(np.maximum(d2, 1e-7)))).to(
        device=device, dtype=torch.float32)
    state = dict(
        anchor=anchor,
        anchor_feat=torch.randn((n, f), **f32) * config["feat_std"],
        hyper_latent=torch.randn((n, mcfg.hyper_dim), **f32)
        * config["hyper_std"],
        offsets=torch.randn((n, k, 3), **f32) * config["offset_std"],
        mask_logit=torch.where(torch.rand((n, k), **f32)
                               < config["mask_keep"], inputs.KEPT_LOGIT,
                               inputs.DROPPED_LOGIT),
        scaling_log=base[:, None] + torch.rand((n, 6), **f32)
        * c["scale_jitter"],
    )
    voxel = (config["voxel_size"] if config["voxel_size"] > 0
             else float(np.median(d2)))
    return state, voxel


def look_at(centre: np.ndarray) -> tuple:
    """(R, T) of a camera at `centre` looking at the origin, image y down
    (R camera-to-world, T world-to-camera, as `inputs.orbit_poses`)."""
    z = -centre / np.linalg.norm(centre)
    x = np.cross(z, UP)
    x /= np.linalg.norm(x)
    rot = np.stack([x, np.cross(z, x), z], axis=1)
    return rot, -rot.T @ centre


def distances(traffic: dict) -> np.ndarray:
    """[views] each view's distance from the ground's centre."""
    views = traffic["views"]
    half = views // 2
    steps = np.minimum(np.arange(views), views - np.arange(views))
    return traffic["far"] * (traffic["near"] / traffic["far"]) ** (
        steps / half)


def flyin_poses(traffic: dict, width: int, height: int) -> list:
    """(R, T, fov_x, fov_y) of the lap's cameras."""
    views = traffic["views"]
    fov_x = traffic["fov_x"]
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * height / width)
    elev = math.radians(traffic["elevation_deg"])
    poses = []
    for i, dist in enumerate(distances(traffic)):
        azim = 2 * math.pi * traffic["turns"] * i / views
        centre = dist * np.array([math.cos(elev) * math.sin(azim),
                                  math.sin(elev),
                                  -math.cos(elev) * math.cos(azim)])
        poses.append((*look_at(centre), fov_x, fov_y))
    return poses


class Job(serve.Job):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        fixed = list(traffic["fixed_views"])
        rest = [v for v in range(traffic["views"]) if v not in fixed]
        rng = np.random.default_rng(inputs.stream_seed(self.seed, "order"))
        self.checked = sorted(fixed + [int(v) for v in rng.choice(
            rest, traffic["checked_views"] - len(fixed), replace=False)])
        self.poses = flyin_poses(traffic, self.width, self.height)

    def _inputs(self):
        if not hasattr(self, "scene"):
            state, voxel = city(self.config, self.seed, self.device)
            self.scene = serve.decoded_arrays(state, self.mcfg.n_offsets)
            self.nets = inputs.net_weights(self.config)
            # the program's decoded scene carries the voxel set-up found
            self.config = dict(self.config, voxel_size=voxel)

    def _on_path(self):
        """`serve`'s run and reference with the lap's cameras in place of
        the orbit's."""
        return replaced(inputs, "orbit_poses",
                        lambda _orbit: lambda *_: self.poses)

    def run(self, seconds: float, tracer=None):
        with self._on_path():
            return super().run(seconds, tracer)

    def checks(self, control: bool = False) -> dict:
        with self._on_path():
            return super().checks(control)
