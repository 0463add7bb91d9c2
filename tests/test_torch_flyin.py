"""The benchmark's fly-in cell (`perfbench/kinds/flyin.py`) on the CPU at a
small size: 4,000 anchors of its city recipe, 192x108 views, views 0 (the
top), 8, 32 (street level) and 48 of its 64-view lap. The port's
decoded-scene renderer agrees with the benchmark's plain reference
(`perfbench/reference/serve.py`, written apart from the port); its
`visible_anchors` and `tile_instances` counters count what the reference
culls and bins; the lap is closed and multi-scale; and a seed gives its
scene again, every seed at the same sizes."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import profile

from contextgs_tpu_torch.compression.codec import DecodedScene
from contextgs_tpu_torch.config import TrainConfig
from contextgs_tpu_torch.evaluation import make_decoded_renderer
from contextgs_tpu_torch.scene.cameras import Camera
from contextgs_tpu_torch.utils import trace
from perfbench import compare, program
from perfbench.kinds import flyin
from perfbench.reference import model as md
from perfbench.reference import raster
from perfbench.reference.serve import make_renderer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = dict(json.loads(
    (REPO / "perfbench/configs/bungeenerf.json").read_text()),
    anchors=4000, width=192, height=108)
TRAFFIC = json.loads(
    (REPO / "perfbench/traffic/serve-flyin.json").read_text())
W, H = CONFIG["width"], CONFIG["height"]
TOP, STREET = 0, 32
VIEWS = (TOP, 8, STREET, 48)
SEED = 2 ** 31 + 23
CPU = torch.device("cpu")
# On the CPU the port and the reference differ by the order of their
# float32 operations alone. In the top view's tile lists of thousands of
# instances that can decide one blend the other way (an alpha at the 1/255
# floor, or the 1e-4 transmittance stop), which moves a pixel by about
# that splat's 1/255 share of its colour (1.3e-3 seen at the top view)...
IMAGE_MAX_ABS = 5e-3
# ...and a view's mean by little: such pixels are a few of its 20,736
# (1.1e-7 seen at the top view)
IMAGE_MEAN_ABS = 1e-6


@pytest.fixture(scope="module")
def lap():
    """Per view: the port's image and counters, and the reference's image,
    visible anchors, kept splats and tile instances."""
    job = flyin.Job(CONFIG, TRAFFIC, SEED, CPU)
    job._inputs()
    s = job.scene
    mcfg = program.model_config(job.config)
    dec = DecodedScene(anchor=s["anchor"], feat=s["feat"],
                       scaling=s["scaling"], offsets=s["offsets"],
                       masks=s["masks"], hyper=s["hyper"],
                       mlps=program.mlps(job.nets, job.config, CPU),
                       prior=None, level_scales=[],
                       voxel_size=mcfg.voxel_size)
    render = make_decoded_renderer(dec, TrainConfig(model=mcfg), W, H, CPU)
    reference = make_renderer(s, job.nets, job.mcfg, W, H, CPU)
    nets = {k: v for k, v in job.nets.items() if k.startswith("mlps.")}
    bg = torch.zeros(3)
    out = {}
    for v in VIEWS:
        r, t, fx, fy = job.poses[v]
        cam = Camera(uid=v, colmap_id=v, R=r, T=t, fov_x=fx, fov_y=fy,
                     image=None, width=W, height=H).as_device_dict()
        trace.take()
        with profile():
            image = render(cam, bg)
        counts: dict = {}
        for c in trace.take().counts:
            counts[c.name] = counts.get(c.name, 0) + c.n
        ref_cam = raster.camera(r, t, fx, fy, CPU)
        with torch.no_grad():
            vis = raster.visible(s["anchor"], s["scaling"][:, :3], ref_cam,
                                 W, H)
            g = md.neural_gaussians(nets, job.mcfg, ref_cam["center"], vis,
                                    s["feat"], s["scaling"], s["offsets"],
                                    s["anchor"], s["masks"])
            splats = raster.project(g.xyz, g.scaling, g.rot, ref_cam, W, H,
                                    valid=g.valid, opacities=g.opacity)
            ids, _ = raster.instances(splats, W)
        out[v] = dict(image=image, counts=counts,
                      reference=reference(ref_cam, bg),
                      visible=int(vis.sum()), kept=int(splats.keep.sum()),
                      instances=ids.numel())
    return out


@pytest.mark.parametrize("view", VIEWS)
def test_the_port_agrees_with_the_reference(lap, view):
    worst_max, worst_mean = compare.image_gaps([lap[view]["image"]],
                                               [lap[view]["reference"]])
    assert worst_max <= IMAGE_MAX_ABS, worst_max
    assert worst_mean <= IMAGE_MEAN_ABS, worst_mean


@pytest.mark.parametrize("view", VIEWS)
def test_the_counters_count_what_the_reference_culls_and_bins(lap, view):
    got = lap[view]
    assert got["counts"]["visible_anchors"] == got["visible"]
    assert got["counts"]["tile_instances"] == got["instances"]


def test_the_lap_is_multi_scale(lap):
    """The top keeps nearly every anchor, each splat over a tile or two;
    street level a few percent, each splat over many tiles."""
    n = CONFIG["anchors"]
    assert lap[TOP]["counts"]["visible_anchors"] >= 0.85 * n
    assert lap[STREET]["counts"]["visible_anchors"] <= 0.20 * n
    top, street = (lap[v]["instances"] / lap[v]["kept"]
                   for v in (TOP, STREET))
    assert top < 4 and street > 10, (top, street)


def test_the_lap_is_closed_and_spans_64x():
    poses = flyin.flyin_poses(TRAFFIC, W, H)
    centres = np.array([-r @ t for r, t, *_ in poses])
    dist = np.linalg.norm(centres, axis=1)
    assert dist.max() / dist.min() == pytest.approx(64.0)
    assert dist.max() < raster.CAMERA_ZFAR
    # every step of the lap, the last view back to the first among them,
    # moves the camera by the same factor in distance and the same azimuth
    nxt = np.roll(np.arange(len(poses)), -1)
    ratio = np.maximum(dist[nxt] / dist, dist / dist[nxt])
    assert ratio == pytest.approx(64.0 ** (2 / len(poses)))
    azim = np.arctan2(centres[:, 0], -centres[:, 2])
    turn = np.mod(azim[nxt] - azim, 2 * math.pi)
    assert turn == pytest.approx(2 * math.pi * TRAFFIC["turns"] / len(poses))
    # at 60 degrees throughout, the lowest camera over every roof
    assert centres[:, 1] / dist == pytest.approx(math.sin(math.pi / 3))
    assert centres[:, 1].min() > CONFIG["city"]["height_cap"]
    # each camera looks at the ground's centre
    for (r, t, *_), c in zip(poses, centres):
        assert r[:, 2] == pytest.approx(-c / np.linalg.norm(c))


def test_a_seed_gives_its_scene_and_every_seed_the_same_sizes():
    small = dict(CONFIG, anchors=500)
    a, voxel_a = flyin.city(small, SEED, CPU)
    b, voxel_b = flyin.city(small, SEED, CPU)
    c, _ = flyin.city(small, SEED + 1, CPU)
    assert voxel_a == voxel_b > 0
    for name in a:
        assert torch.equal(a[name], b[name]), name
        assert a[name].shape == c[name].shape, name
    assert not torch.equal(a["anchor"], c["anchor"])


@pytest.mark.parametrize("seed", [SEED, SEED + 1, 7])
def test_the_top_and_street_level_are_checked(seed):
    checked = flyin.Job(CONFIG, TRAFFIC, seed, CPU).checked
    assert len(set(checked)) == TRAFFIC["checked_views"]
    assert TOP in checked and STREET in checked
