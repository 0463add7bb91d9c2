"""Scene rendering: prefilter → neural gaussian decode → tile rasterization
(port of `contextgs_tpu/models/renderer.py`), differentiable.

The device is that of the scene's tensors; camera fields may be numpy arrays
or tensors and are moved there. Only the anchors that pass the prefilter are
decoded and rasterized, as the CUDA reference does; the per-gaussian outputs
(`gaussians`, `radii`, `visibility`) are scattered back to the reference's
N·K slots, with the slots of the other anchors zero (culled), and a
`screen_dummy` of N·K rows receives its gradient in those slots. Images,
gradients and densification statistics equal the reference's static-shape
path, where those slots are culled too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                        PipelineConfig)
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.decode import (DecodeAux, NeuralGaussians,
                                               generate_neural_gaussians)
from contextgs_tpu_torch.models.levels import LevelMaps
from contextgs_tpu_torch.ops import rasterize as rz
from contextgs_tpu_torch.utils import trace


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
    fields = {k: v for k, v in cam.items() if k not in ("tanfovx", "tanfovy")}
    # a host array's copy to the card waits for it
    with trace.sync("camera", sum(not isinstance(v, torch.Tensor)
                                  for v in fields.values())):
        out = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
               for k, v in fields.items()}
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


def _to_slots(x: torch.Tensor, slots: torch.Tensor, nk: int) -> torch.Tensor:
    """Rows of the decoded slots → [N·K, ...], zero elsewhere."""
    return x.new_zeros((nk,) + x.shape[1:]).index_copy(0, slots, x)


def render(params: st.Params, buffers: st.Buffers, cfg: ModelConfig,
           opt: OptimizationConfig, pipe: PipelineConfig, cam: dict,
           width: int, height: int, bg: torch.Tensor,
           generator: torch.Generator | None = None,
           *, phase: str, training: bool = False,
           maps: LevelMaps | None = None,
           visible_mask: torch.Tensor | None = None,
           screen_dummy: torch.Tensor | None = None,
           scale_modifier=1.0) -> RenderOutput:
    """Render one view; differentiable in the parameters and `screen_dummy`
    ([N·K, 2], the densification hook). `generator` draws the noise and
    context phases' noise; `maps` are the context phase's level maps. The
    anchors the cull keeps are counted into the trace counter
    `render_visible_anchors`."""
    if pipe.tile_size != rz.TILE:
        raise ValueError(f"the port rasterizes {rz.TILE}x{rz.TILE} tiles, "
                         f"got pipe.tile_size={pipe.tile_size}")
    dev = params.anchor.device
    cam = camera_tensors(cam, dev)
    if visible_mask is None:
        with trace.span("render/cull"):
            visible_mask = prefilter_voxel(params, buffers, cam, width,
                                           height)
    k = cfg.n_offsets
    nk = params.offsets.shape[0] * k
    with trace.sync("render.visible"):
        index = torch.nonzero(visible_mask).squeeze(1)
    trace.count("render_visible_anchors", index.numel())
    slots = (index[:, None] * k + torch.arange(k, device=dev)).reshape(-1)

    with trace.span("render/decode"):
        ng, aux = generate_neural_gaussians(
            params, buffers, cfg, opt, cam["camera_center"], visible_mask,
            generator, phase=phase, training=training, anchor_index=index,
            maps=maps)
    if screen_dummy is not None:
        screen_dummy = screen_dummy[slots]

    out = rz.rasterize(
        ng.xyz, ng.scaling, ng.rot, ng.color, ng.opacity,
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
        width=width, height=height, bg=bg.to(dev),
        valid=ng.gauss_valid, screen_dummy=screen_dummy,
        scale_modifier=scale_modifier)

    gaussians = NeuralGaussians(
        *(_to_slots(x, slots, nk) for x in ng[:-1]),
        anchor_visible=visible_mask)
    return RenderOutput(image=out.image, final_t=out.final_t,
                        gaussians=gaussians,
                        radii=_to_slots(out.radii, slots, nk),
                        visibility=_to_slots(out.visibility, slots, nk),
                        aux=aux, overflowed=out.overflowed,
                        vis_overflowed=out.vis_overflowed,
                        n_instances=out.n_instances, n_vis=out.n_vis)
