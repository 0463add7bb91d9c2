"""Differentiable rasterizer API (port of
`contextgs_tpu/ops/rasterize/__init__.py`).

`rasterize(...)` projects the gaussians, bins and depth-sorts their tile
instances and blends the tiles. The blend is a `torch.autograd.Function`
(`_TileBlend`, the counterpart of the reference's `_pack_blend` custom VJP):
its forward is K1 (`tile_kernel.blend_forward`) and its backward K2
(`tile_kernel.blend_backward`), which gives dL/d rows [G,9]; autograd of
`splat_rows` and of `project_gaussians` (on CUDA tensors the projection's
own kernel pair, `projection._Projection`) carries that on to the means,
scales, quats, colors, opacities and `screen_dummy`. The backend follows the
tensors: on CUDA tensors the hand-written kernels run, on CPU tensors their
plain versions (`reference.blend_tiles_reference`,
`reference.blend_tiles_backward_reference` and
`projection.project_gaussians_plain`).
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
from contextgs_tpu_torch.ops.rasterize.tile_kernel import (TILE,
                                                           blend_backward,
                                                           blend_forward)
from contextgs_tpu_torch.utils import trace

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


class _TileBlend(torch.autograd.Function):
    """rows [G,9] → (rgb [3,H,W], final_T [H,W]); K1 forward, K2 backward.

    `blend_forward` and `blend_backward` are looked up in this module when
    called, so that a caller may wrap them (chip_smoke.py times them so)."""

    @staticmethod
    def forward(ctx, rows, gauss_ids, tile_bounds, width, height, t_eps,
                row_offset):
        rgb, final_t, last = blend_forward(rows, gauss_ids, tile_bounds,
                                           width, height, t_eps, row_offset)
        ctx.save_for_backward(rows, gauss_ids, tile_bounds, rgb, final_t,
                              last)
        ctx.dims = (width, height, t_eps, row_offset)
        return rgb, final_t

    @staticmethod
    def backward(ctx, d_rgb, d_final_t):
        width, height, t_eps, row_offset = ctx.dims
        with trace.span("raster/blend_backward"):
            d_rows = blend_backward(*ctx.saved_tensors, d_rgb.contiguous(),
                                    d_final_t.contiguous(), width, height,
                                    t_eps, row_offset)
        return d_rows, None, None, None, None, None, None


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
    tile_band: tuple | None = None,
) -> RasterOutput:
    """Differentiable tile rasterization of 3D gaussians.

    `valid` force-culls gaussian slots. `screen_dummy` is the densification
    hook of the reference: added to the projected means scaled by
    (0.5·W, 0.5·H). `t_eps` overrides the early-termination threshold.
    With `tile_band=(row0, n_rows)` only that horizontal band of tiles is
    rasterized: `image` and `final_t` are [.., n_rows·16, W], rows past the
    image render background (every band has the same shape), and `radii`
    and `visibility` say which gaussians touch the band."""
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    row0 = 0 if tile_band is None else tile_band[0]
    band_rows = tiles_y if tile_band is None else tile_band[1]
    band_h = height if tile_band is None else band_rows * TILE
    with trace.span("raster/project"):
        proj = project_gaussians(means3d, scales, quats, world_view,
                                 full_proj, tanfovx, tanfovy, width, height,
                                 TILE, scale_modifier, valid=valid,
                                 opacities=opacities, tile_band=tile_band)
        if screen_dummy is not None:
            with trace.sync("raster.ndc_scale"):
                ndc_scale = torch.tensor([0.5 * width, 0.5 * height],
                                         dtype=means3d.dtype,
                                         device=means3d.device)
            proj = proj._replace(
                means2d=proj.means2d + screen_dummy * ndc_scale)
    with trace.span("raster/bin"):
        inst = expand_and_sort(proj, tiles_x, band_rows, row0)
    with trace.span("raster/blend"):
        img, final_t = _TileBlend.apply(
            splat_rows(proj, colors, opacities), inst.gauss_ids,
            inst.tile_bounds, width, band_h,
            T_EPS if t_eps is None else t_eps, row0)
    image = img + final_t[None] * bg[:, None, None]
    return RasterOutput(image=image, final_t=final_t, radii=proj.radii,
                        visibility=proj.radii > 0, overflowed=False,
                        vis_overflowed=False, n_instances=inst.demand,
                        n_vis=inst.n_vis)
