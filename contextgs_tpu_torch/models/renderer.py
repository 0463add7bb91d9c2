"""Scene rendering: prefilter → neural gaussian decode → tile rasterization
(port of `contextgs_tpu/models/renderer.py`, forward).

The device is that of the scene's tensors; camera fields may be numpy arrays
or tensors and are moved there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                        PipelineConfig)
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.decode import (DecodeAux, NeuralGaussians,
                                               generate_neural_gaussians)
from contextgs_tpu_torch.ops import rasterize as rz


class RenderOutput(NamedTuple):
    image: torch.Tensor           # [3,H,W]
    final_t: torch.Tensor         # [H,W]
    gaussians: NeuralGaussians
    radii: torch.Tensor           # [NK] int32
    visibility: torch.Tensor      # [NK] bool (radius>0)
    aux: DecodeAux
    overflowed: bool
    vis_overflowed: bool
    n_instances: int              # tile-instance count
    n_vis: torch.Tensor           # [] gaussians touching >=1 tile


def camera_tensors(cam: dict, device) -> dict:
    """Camera dict (numpy or tensors) → float32 tensors on `device`; the two
    tan(fov/2) stay Python floats."""
    out = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
           for k, v in cam.items() if k not in ("tanfovx", "tanfovy")}
    out["tanfovx"] = float(cam["tanfovx"])
    out["tanfovy"] = float(cam["tanfovy"])
    return out


def prefilter_voxel(params: st.Params, buffers: st.Buffers, cam: dict,
                    width: int, height: int) -> torch.Tensor:
    """Anchor frustum culling: anchors tested with their first-3 scaling and
    identity rotation."""
    cam = camera_tensors(cam, params.anchor.device)
    anchor_q = st.get_anchor(params, buffers)
    scales = st.get_scaling(params)[:, :3]
    vis = rz.visible_filter(anchor_q, scales, cam["world_view"],
                            cam["full_proj"], cam["tanfovx"], cam["tanfovy"],
                            width, height, valid=buffers.alive)
    return vis & buffers.alive


def render(params: st.Params, buffers: st.Buffers, cfg: ModelConfig,
           opt: OptimizationConfig, pipe: PipelineConfig, cam: dict,
           width: int, height: int, bg: torch.Tensor,
           generator: torch.Generator | None = None,
           *, phase: str, training: bool = False,
           visible_mask: torch.Tensor | None = None,
           screen_dummy: torch.Tensor | None = None,
           scale_modifier=1.0) -> RenderOutput:
    """Render one view. Forward only in this port slice: `training=True`
    needs the backward kernel of the training slice."""
    if pipe.tile_size != rz.TILE:
        raise ValueError(f"the port rasterizes {rz.TILE}x{rz.TILE} tiles, "
                         f"got pipe.tile_size={pipe.tile_size}")
    if training:
        raise NotImplementedError(
            "render(training=True) needs the tile-blend backward, which comes "
            "with the training slice (ROADMAP.md queue 1, slice 2)")
    cam = camera_tensors(cam, params.anchor.device)
    if visible_mask is None:
        visible_mask = prefilter_voxel(params, buffers, cam, width, height)

    ng, aux = generate_neural_gaussians(
        params, buffers, cfg, opt, cam["camera_center"], visible_mask,
        generator, phase=phase, training=training)

    out = rz.rasterize(
        ng.xyz, ng.scaling, ng.rot, ng.color, ng.opacity,
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
        width=width, height=height, bg=bg.to(params.anchor.device),
        valid=ng.gauss_valid, screen_dummy=screen_dummy,
        scale_modifier=scale_modifier)

    return RenderOutput(image=out.image, final_t=out.final_t, gaussians=ng,
                        radii=out.radii, visibility=out.visibility, aux=aux,
                        overflowed=out.overflowed,
                        vis_overflowed=out.vis_overflowed,
                        n_instances=out.n_instances, n_vis=out.n_vis)
