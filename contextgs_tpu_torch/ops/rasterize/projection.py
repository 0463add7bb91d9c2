"""Gaussian projection: 3D covariance → EWA 2D conic, culling, tile extents
(port of `contextgs_tpu/ops/rasterize/projection.py`).

Forward math of the CUDA reference rasterizer: view-space z cull at 0.2,
frustum clamp at 1.3*tanfov inside the Jacobian, +0.3 screen-space dilation,
radius = ceil(3*sqrt(max eigenvalue)), ndc2Pix(v) = ((v+1)*S - 1)/2, and the
opacity-aware ellipse-bbox tile rect. The arithmetic follows the JAX
function term by term so that both packages round alike.

Matrix convention: row-vector transforms, `[p,1] @ M` (see scene/cameras.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities, all [G, ...]."""

    means2d: torch.Tensor    # [G,2] pixel coords
    conics: torch.Tensor     # [G,3] inverse 2D covariance (a, b, c)
    depths: torch.Tensor     # [G] view-space z
    radii: torch.Tensor      # [G] int32 screen radius (0 = culled)
    rect_min: torch.Tensor   # [G,2] int32 inclusive tile rect min (x, y)
    rect_max: torch.Tensor   # [G,2] int32 exclusive tile rect max (x, y)
    n_tiles: torch.Tensor    # [G] int32 tiles touched (0 = culled)


def project_gaussians(
    means3d: torch.Tensor,       # [G,3]
    scales: torch.Tensor,        # [G,3]
    quats: torch.Tensor,         # [G,4] normalized (w,x,y,z)
    world_view: torch.Tensor,    # [4,4] transposed W2V
    full_proj: torch.Tensor,     # [4,4] transposed world→clip
    tanfovx: float,
    tanfovy: float,
    width: int,
    height: int,
    tile_size: int = 16,
    scale_modifier: float = 1.0,
    valid: torch.Tensor | None = None,      # [G] bool; False → force-cull
    opacities: torch.Tensor | None = None,  # [G]; enables the tight
                                            # opacity-aware ellipse-bbox rect
    tile_band: tuple | None = None,         # (row0, n_rows): clamp rects to a
                                            # horizontal tile band
) -> ProjectedGaussians:
    """EWA-project all gaussians to screen space. With `tile_band`, the
    rects are clamped to that band's tile rows (multi-GPU tile sharding); a
    gaussian that misses the band gets radius 0."""
    tanfovx, tanfovy = float(tanfovx), float(tanfovy)
    G = means3d.shape[0]
    ones = torch.ones((G, 1), dtype=means3d.dtype, device=means3d.device)
    p_hom4 = torch.cat([means3d, ones], dim=1)

    p_view = p_hom4 @ world_view            # [G,4]
    depths = p_view[:, 2]

    p_clip = p_hom4 @ full_proj             # [G,4]
    p_w = 1.0 / (p_clip[:, 3] + 1e-7)
    p_proj = p_clip[:, :3] * p_w[:, None]

    # --- 2D covariance via EWA splatting ---
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)
    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    z = depths
    safe_z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    tx = torch.clamp(p_view[:, 0] / safe_z, -lim_x, lim_x) * z
    ty = torch.clamp(p_view[:, 1] / safe_z, -lim_y, lim_y) * z
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z

    # EWA cov2d = T Σ Tᵀ with T = J·Rv, written out per gaussian
    Rv = world_view[:3, :3].T               # world→view rotation (constant 3x3)
    fxi = focal_x * inv_z
    fyi = focal_y * inv_z
    gx = -focal_x * tx * inv_z2
    gy = -focal_y * ty * inv_z2
    T00 = fxi * Rv[0, 0] + gx * Rv[2, 0]
    T01 = fxi * Rv[0, 1] + gx * Rv[2, 1]
    T02 = fxi * Rv[0, 2] + gx * Rv[2, 2]
    T10 = fyi * Rv[1, 0] + gy * Rv[2, 0]
    T11 = fyi * Rv[1, 1] + gy * Rv[2, 1]
    T12 = fyi * Rv[1, 2] + gy * Rv[2, 2]

    # Σ = R S² Rᵀ (3DGS convention), 6 unique entries via M = R·diag(s)
    w, x, y_, zq = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    s0 = scales[:, 0] * scale_modifier
    s1 = scales[:, 1] * scale_modifier
    s2 = scales[:, 2] * scale_modifier
    R00 = 1 - 2 * (y_ * y_ + zq * zq)
    R01 = 2 * (x * y_ - w * zq)
    R02 = 2 * (x * zq + w * y_)
    R10 = 2 * (x * y_ + w * zq)
    R11 = 1 - 2 * (x * x + zq * zq)
    R12 = 2 * (y_ * zq - w * x)
    R20 = 2 * (x * zq - w * y_)
    R21 = 2 * (y_ * zq + w * x)
    R22 = 1 - 2 * (x * x + y_ * y_)
    M00, M01, M02 = R00 * s0, R01 * s1, R02 * s2
    M10, M11, M12 = R10 * s0, R11 * s1, R12 * s2
    M20, M21, M22 = R20 * s0, R21 * s1, R22 * s2
    C00 = M00 * M00 + M01 * M01 + M02 * M02
    C01 = M00 * M10 + M01 * M11 + M02 * M12
    C02 = M00 * M20 + M01 * M21 + M02 * M22
    C11 = M10 * M10 + M11 * M11 + M12 * M12
    C12 = M10 * M20 + M11 * M21 + M12 * M22
    C22 = M20 * M20 + M21 * M21 + M22 * M22

    def quad(Ta0, Ta1, Ta2, Tb0, Tb1, Tb2):
        return (Ta0 * Tb0 * C00 + Ta1 * Tb1 * C11 + Ta2 * Tb2 * C22
                + (Ta0 * Tb1 + Ta1 * Tb0) * C01
                + (Ta0 * Tb2 + Ta2 * Tb0) * C02
                + (Ta1 * Tb2 + Ta2 * Tb1) * C12)

    a = quad(T00, T01, T02, T00, T01, T02) + 0.3
    b = quad(T00, T01, T02, T10, T11, T12)
    c = quad(T10, T11, T12, T10, T11, T12) + 0.3
    det = a * c - b * b
    det_ok = det > 0
    safe_det = torch.where(det_ok, det, 1.0)
    inv_det = 1.0 / safe_det
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))

    means2d = torch.stack([
        ((p_proj[:, 0] + 1.0) * width - 1.0) * 0.5,
        ((p_proj[:, 1] + 1.0) * height - 1.0) * 0.5,
    ], dim=-1)

    # --- tile rect (getRect semantics: min inclusive, max exclusive) ---
    tiles_x = (width + tile_size - 1) // tile_size
    tiles_y = (height + tile_size - 1) // tile_size
    row_lo, row_hi = 0, tiles_y
    if tile_band is not None:
        # bands may lie partly or wholly below the image (every rank's
        # shapes agree); the clamp keeps lo <= hi, and a band wholly
        # outside gets empty rects
        row_lo = min(tile_band[0], tiles_y)
        row_hi = min(tile_band[0] + tile_band[1], tiles_y)
    m2i = means2d.detach()
    r = radius_f.detach()
    if opacities is not None:
        # opacity-aware ellipse bbox: a pixel survives the blend's skip rule
        # iff op·exp(power) ≥ 1/255, i.e. Mahalanobis² ≤ k² = 2·ln(255·op);
        # the bbox of that ellipse has half-extents k·√a, k·√c, intersected
        # with the 3σ circle r. op < 1/255 culls the gaussian outright.
        op = opacities.detach()
        k = torch.sqrt(torch.clamp(
            2.0 * torch.log(torch.clamp(255.0 * op, min=1e-30)), min=0.0))
        rx = torch.minimum(torch.ceil(k * torch.sqrt(torch.clamp(a, min=0.0))), r)
        ry = torch.minimum(torch.ceil(k * torch.sqrt(torch.clamp(c, min=0.0))), r)
    else:
        rx = ry = r
    # .to(int32) truncates toward zero, as astype(int32) does in the reference
    rect_min = torch.stack([
        torch.clamp(((m2i[:, 0] - rx) / tile_size).to(torch.int32), 0, tiles_x),
        torch.clamp(((m2i[:, 1] - ry) / tile_size).to(torch.int32), row_lo,
                    row_hi),
    ], dim=-1)
    rect_max = torch.stack([
        torch.clamp(((m2i[:, 0] + rx + tile_size - 1) / tile_size).to(torch.int32),
                    0, tiles_x),
        torch.clamp(((m2i[:, 1] + ry + tile_size - 1) / tile_size).to(torch.int32),
                    row_lo, row_hi),
    ], dim=-1)

    keep = det_ok & (depths > 0.2)
    if opacities is not None:
        keep = keep & (opacities.detach() >= 1.0 / 255.0)
    if valid is not None:
        keep = keep & valid
    n_tiles = torch.where(
        keep,
        (rect_max[:, 0] - rect_min[:, 0]) * (rect_max[:, 1] - rect_min[:, 1]), 0)
    keep = keep & (n_tiles > 0)
    radii = torch.where(keep, r, 0.0).to(torch.int32)
    n_tiles = torch.where(keep, n_tiles, 0).to(torch.int32)

    return ProjectedGaussians(means2d=means2d, conics=conics, depths=depths,
                              radii=radii, rect_min=rect_min, rect_max=rect_max,
                              n_tiles=n_tiles)


def visible_filter(
    means3d: torch.Tensor, scales: torch.Tensor, world_view: torch.Tensor,
    full_proj: torch.Tensor, tanfovx: float, tanfovy: float,
    width: int, height: int, valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Anchor frustum-cull mask (the reference's prefilter_voxel: identity
    rotation, radius>0 test)."""
    G = means3d.shape[0]
    quats = torch.zeros((G, 4), dtype=means3d.dtype, device=means3d.device)
    quats[:, 0] = 1.0
    proj = project_gaussians(means3d, scales, quats, world_view, full_proj,
                             tanfovx, tanfovy, width, height, valid=valid)
    return proj.radii > 0

