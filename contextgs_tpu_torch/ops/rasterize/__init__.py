"""Rasterizer API, forward (port of `contextgs_tpu/ops/rasterize/__init__.py`).

`rasterize(...)` projects the gaussians, bins and depth-sorts their tile
instances and blends the tiles. The backend follows the tensors: on CUDA
tensors the blend is the hand-written kernel K1 (`tile_kernel.blend_forward`),
on CPU tensors its plain version (`reference.blend_tiles_reference`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contextgs_tpu_torch.ops.rasterize.common import T_EPS
from contextgs_tpu_torch.ops.rasterize.projection import (ProjectedGaussians,
                                                          project_gaussians,
                                                          visible_filter)
from contextgs_tpu_torch.ops.rasterize.sorting import (TileInstances,
                                                       expand_and_sort)
from contextgs_tpu_torch.ops.rasterize.tile_kernel import TILE, blend_forward

__all__ = ["rasterize", "visible_filter", "project_gaussians",
           "expand_and_sort", "splat_rows", "RasterOutput",
           "ProjectedGaussians", "TileInstances", "TILE"]


class RasterOutput(NamedTuple):
    image: torch.Tensor        # [3,H,W] composited with background
    final_t: torch.Tensor      # [H,W] final transmittance
    radii: torch.Tensor        # [G] int32
    visibility: torch.Tensor   # [G] bool (radius > 0)
    overflowed: bool           # always False: instance lists are dynamic
    vis_overflowed: bool       # always False: no visible-gaussian cap
    n_instances: int           # tile instances (the sort's demand)
    n_vis: torch.Tensor        # [] gaussians touching >= 1 tile


def splat_rows(proj: ProjectedGaussians, colors: torch.Tensor,
               opacities: torch.Tensor) -> torch.Tensor:
    """[G,9] per-gaussian blend rows: mean xy, conic abc, opacity, rgb."""
    return torch.cat([proj.means2d, proj.conics, opacities[:, None], colors],
                     dim=1)


def rasterize(
    means3d: torch.Tensor,      # [G,3]
    scales: torch.Tensor,       # [G,3]
    quats: torch.Tensor,        # [G,4] normalized
    colors: torch.Tensor,       # [G,3]
    opacities: torch.Tensor,    # [G]
    *,
    world_view: torch.Tensor,
    full_proj: torch.Tensor,
    tanfovx,
    tanfovy,
    width: int,
    height: int,
    bg: torch.Tensor,           # [3]
    valid: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    screen_dummy: torch.Tensor | None = None,
    t_eps: float | None = None,
) -> RasterOutput:
    """Tile rasterization of 3D gaussians (forward).

    `valid` force-culls gaussian slots. `screen_dummy` is the densification
    hook of the reference: added to the projected means scaled by
    (0.5·W, 0.5·H). `t_eps` overrides the early-termination threshold."""
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    proj = project_gaussians(means3d, scales, quats, world_view, full_proj,
                             tanfovx, tanfovy, width, height, TILE,
                             scale_modifier, valid=valid, opacities=opacities)
    if screen_dummy is not None:
        ndc_scale = torch.tensor([0.5 * width, 0.5 * height],
                                 dtype=means3d.dtype, device=means3d.device)
        proj = proj._replace(means2d=proj.means2d + screen_dummy * ndc_scale)
    inst = expand_and_sort(proj, tiles_x, tiles_y)
    img, final_t, _ = blend_forward(
        splat_rows(proj, colors, opacities), inst.gauss_ids, inst.tile_bounds,
        width, height, T_EPS if t_eps is None else t_eps)
    image = img + final_t[None] * bg[:, None, None]
    return RasterOutput(image=image, final_t=final_t, radii=proj.radii,
                        visibility=proj.radii > 0, overflowed=False,
                        vis_overflowed=False, n_instances=inst.demand,
                        n_vis=inst.n_vis)
