"""The reference's view of a decoded scene: the anchors' frustum cull, every
anchor's neural gaussians, and the rasterizer (`raster.rasterize`)."""

from __future__ import annotations

import torch

from perfbench.reference import model as md
from perfbench.reference import raster


def make_renderer(scene: dict, nets: dict, model: md.Model, width: int,
                  height: int, device):
    """`render(cam, bg) -> [3,H,W]` of the decoded arrays of `scene`
    (anchor, feat, scaling (linear), offsets [N,K,3], masks {0,1}) with
    the decoder MLPs of `nets`; `cam` is a `raster.camera`."""
    m = {k: v.to(device) for k, v in nets.items() if k.startswith("mlps.")}

    @torch.no_grad()
    def render(cam: dict, bg: torch.Tensor) -> torch.Tensor:
        vis = raster.visible(scene["anchor"], scene["scaling"][:, :3], cam,
                             width, height)
        g = md.neural_gaussians(m, model, cam["center"], vis, scene["feat"],
                                scene["scaling"], scene["offsets"],
                                scene["anchor"], scene["masks"])
        return raster.rasterize(g.xyz, g.scaling, g.rot, g.color, g.opacity,
                                cam, width, height, bg, valid=g.valid)

    return render
