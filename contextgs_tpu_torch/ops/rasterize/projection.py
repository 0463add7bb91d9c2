"""Gaussian projection: 3D covariance → EWA 2D conic, culling, tile extents
(port of `contextgs_tpu/ops/rasterize/projection.py`).

Forward math of the CUDA reference rasterizer: view-space z cull at 0.2,
frustum clamp at 1.3*tanfov inside the Jacobian, +0.3 screen-space dilation,
radius = ceil(3*sqrt(max eigenvalue)), ndc2Pix(v) = ((v+1)*S - 1)/2, and the
opacity-aware ellipse-bbox tile rect.

`project_gaussians` and `visible_filter` follow the tensors: on CUDA tensors
they launch the hand-written kernels of `csrc/projection.cu`, one launch a
call (the projection, the anchor cull, and the projection's backward under
autograd, `_Projection`); on CPU tensors they run the plain op chain,
`project_gaussians_plain` and `visible_filter_plain`, whose arithmetic follows
the JAX function term by term so that both packages round alike. Neither
falls back to the other. `launches`, `cull_launches` and
`backward_launches` count the kernels' launches in this process; every call
adds its gaussians to the trace counter `proj_gaussians`, and a kernel call
to `proj_card_gaussians` too.

Matrix convention: row-vector transforms, `[p,1] @ M` (see scene/cameras.py).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from contextgs_tpu_torch.ops.cuda_build import c_function, launch
from contextgs_tpu_torch.utils import trace

SOURCE = Path(__file__).resolve().parent / "csrc" / "projection.cu"
_P, _L, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                  ctypes.c_int)
CAMERA_ARGTYPES = [_P, _L, _L] * 2 + [_L]      # two strided [4,4], G
FORWARD_ARGTYPES = ([_P, _L] * 5 + CAMERA_ARGTYPES + [_F] * 9 + [_I] * 3
                    + [_F] + [_P] * 9)
BACKWARD_ARGTYPES = ([_P, _L] * 3 + CAMERA_ARGTYPES + [_F] * 7 + [_P, _L] * 3
                     + [_P] * 4)
OPACITY_MIN = 1.0 / 255.0    # opacities below it are culled

launches = 0
cull_launches = 0
backward_launches = 0


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities, all [G, ...]."""

    means2d: torch.Tensor    # [G,2] pixel coords
    conics: torch.Tensor     # [G,3] inverse 2D covariance (a, b, c)
    depths: torch.Tensor     # [G] view-space z
    radii: torch.Tensor      # [G] int32 screen radius (0 = culled)
    rect_min: torch.Tensor   # [G,2] int32 inclusive tile rect min (x, y)
    rect_max: torch.Tensor   # [G,2] int32 exclusive tile rect max (x, y)
    n_tiles: torch.Tensor    # [G] int32 tiles touched (0 = culled)


def project_gaussians_plain(
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
    """The plain op chain of `project_gaussians`: the kernel's plain version,
    which CPU tensors take."""
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


def visible_filter_plain(
    means3d: torch.Tensor, scales: torch.Tensor, world_view: torch.Tensor,
    full_proj: torch.Tensor, tanfovx: float, tanfovy: float,
    width: int, height: int, valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain op chain of `visible_filter`: the cull kernel's plain
    version, which CPU tensors take."""
    G = means3d.shape[0]
    quats = torch.zeros((G, 4), dtype=means3d.dtype, device=means3d.device)
    quats[:, 0] = 1.0
    proj = project_gaussians_plain(means3d, scales, quats, world_view,
                                   full_proj, tanfovx, tanfovy, width,
                                   height, valid=valid)
    return proj.radii > 0



# ---- the kernels ----


def _geometry(tanfovx, tanfovy, width, height, tile_size, scale_modifier,
              tile_band):
    """The plain chain's scalars as the kernels take them, computed in
    Python floats as the chain computes them (each becomes a float32 where
    it meets a tensor): focal x, y; frustum limits x, y; width, height;
    scale modifier; tile size and its float32 reciprocal (the card divides
    by a host scalar so); tiles across, and the rows the rects clamp to."""
    tanfovx, tanfovy = float(tanfovx), float(tanfovy)
    tiles_x = (width + tile_size - 1) // tile_size
    tiles_y = (height + tile_size - 1) // tile_size
    row_lo, row_hi = 0, tiles_y
    if tile_band is not None:
        row_lo = min(tile_band[0], tiles_y)
        row_hi = min(tile_band[0] + tile_band[1], tiles_y)
    return (width / (2.0 * tanfovx), height / (2.0 * tanfovy),
            1.3 * tanfovx, 1.3 * tanfovy, float(width), float(height),
            float(scale_modifier), float(tile_size),
            float(np.float32(1.0) / np.float32(tile_size)), tiles_x, row_lo,
            row_hi)


def _rows(name, x, cols, n, device):
    """(pointer, row stride) of a [n, cols] float32 tensor on `device` whose
    columns lie contiguous; raise on anything else."""
    if (x.device != device or x.dtype != torch.float32 or x.dim() != 2
            or x.shape[0] != n or x.shape[1] != cols
            or x.stride(1) != 1):
        raise ValueError(f"project_gaussians: {name} must be a float32 "
                         f"[{n},{cols}] tensor on {device} with contiguous "
                         f"columns, got {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()} on {x.device}")
    return x.data_ptr(), x.stride(0)


def _vector(name, x, dtype, n, device):
    """(pointer, stride) of an optional [n] tensor of `dtype` on `device`."""
    if x is None:
        return None, 0
    if (x.device != device or x.dtype != dtype or x.dim() != 1
            or x.shape[0] != n):
        raise ValueError(f"project_gaussians: {name} must be a {dtype} [{n}]"
                         f" tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    return x.data_ptr(), x.stride(0)


def _camera(world_view, full_proj, device):
    """(pointer, row stride, column stride) of each camera matrix: any
    strides, so a transposed array needs no copy."""
    args = []
    for name, m in (("world_view", world_view), ("full_proj", full_proj)):
        if (m.device != device or m.dtype != torch.float32
                or tuple(m.shape) != (4, 4)):
            raise ValueError(f"project_gaussians: {name} must be a float32 "
                             f"[4,4] tensor on {device}, got {m.dtype} "
                             f"{tuple(m.shape)} on {m.device}")
        if m.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"project_gaussians: the kernels give no "
                             f"gradient of {name}")
        args += (m.data_ptr(), *m.stride())
    return args


def _forward_args(means3d, scales, quats, opacities, valid, world_view,
                  full_proj):
    """The forward kernel's input arguments, each input checked."""
    dev, n = means3d.device, means3d.shape[0]
    quat_args = ((None, 0) if quats is None
                 else _rows("quats", quats, 4, n, dev))
    return (*_rows("means3d", means3d, 3, n, dev),
            *_rows("scales", scales, 3, n, dev), *quat_args,
            *_vector("opacities", opacities, torch.float32, n, dev),
            *_vector("valid", valid, torch.bool, n, dev),
            *_camera(world_view, full_proj, dev), n)


def _launch(name, fn, device, args):
    err = launch(fn, device, *args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


# (int32, columns) of each output in its allocation, one after another:
# means2d, conics, depths, radii, rect_min, rect_max, n_tiles (48 bytes a
# gaussian); and of the backward's d means3d, d scales, d quats
_OUTPUT_LAYOUT = ((False, 2), (False, 3), (False, 0), (True, 0), (True, 2),
                  (True, 2), (True, 0))
_GRAD_LAYOUT = ((False, 3), (False, 3), (False, 4))


def _views(buf, n, layout) -> list:
    """Contiguous [n] or [n, columns] views of `buf`, one after another,
    each float32 or int32 as `layout` says (one strided view each, the
    host's cheapest way)."""
    ints = buf.view(torch.int32)
    views, at = [], 0
    for is_int, cols in layout:
        src = ints if is_int else buf
        if cols:
            views.append(src.as_strided((n, cols), (cols, 1), at))
        else:
            views.append(src.as_strided((n,), (1,), at))
        at += n * max(cols, 1)
    return views


def _project_forward(means3d, scales, quats, opacities, valid, world_view,
                     full_proj, geom) -> ProjectedGaussians:
    """One launch of the projection kernel; the outputs are views of one
    allocation of 48 bytes a gaussian."""
    global launches
    n = means3d.shape[0]
    args = _forward_args(means3d, scales, quats, opacities, valid,
                         world_view, full_proj)
    out = ProjectedGaussians(*_views(
        torch.empty(12 * n, dtype=torch.float32, device=means3d.device),
        n, _OUTPUT_LAYOUT))
    if n:
        _launch("project_gaussians",
                c_function(SOURCE, "project_forward", FORWARD_ARGTYPES),
                means3d.device,
                (*args, *geom, OPACITY_MIN, *(x.data_ptr() for x in out),
                 None))
        launches += 1
    return out


def _cotangent(name, x, cols, n, device):
    """(pointer, row stride, the tensor they point into) of a cotangent,
    (None, 0, None) where autograd gives none; a layout the kernel cannot
    read is copied first, and the copy is held until the launch."""
    if x is None:
        return None, 0, None
    if cols == 1:
        return (*_vector(name, x, torch.float32, n, device), x)
    if x.stride(1) != 1:
        x = x.contiguous()
    return (*_rows(name, x, cols, n, device), x)


def _project_backward(saved, geom, d_means2d, d_conics, d_depths):
    """One launch of the backward kernel → (d means3d, d scales, d quats),
    views of one allocation."""
    global backward_launches
    means3d, scales, quats, world_view, full_proj = saved
    dev, n = means3d.device, means3d.shape[0]
    g_means, g_scales, g_quats = _views(
        torch.empty(10 * n, dtype=torch.float32, device=dev), n,
        _GRAD_LAYOUT)
    cot = [_cotangent("d_means2d", d_means2d, 2, n, dev),
           _cotangent("d_conics", d_conics, 3, n, dev),
           _cotangent("d_depths", d_depths, 1, n, dev)]
    if n:
        _launch("project_gaussians backward",
                c_function(SOURCE, "project_backward", BACKWARD_ARGTYPES),
                dev,
                (*_rows("means3d", means3d, 3, n, dev),
                 *_rows("scales", scales, 3, n, dev),
                 *_rows("quats", quats, 4, n, dev),
                 *_camera(world_view, full_proj, dev), n, *geom[:7],
                 *(v for c in cot for v in c[:2]), g_means.data_ptr(),
                 g_scales.data_ptr(), g_quats.data_ptr()))
        backward_launches += 1
    return g_means, g_scales, g_quats


class _Projection(torch.autograd.Function):
    """(means3d, scales, quats) → the seven outputs of `project_gaussians`;
    the kernel's forward and backward, one launch each. The integer outputs
    are not differentiable; opacities, valid and the camera get no
    gradient, as in the plain chain (the camera's is refused)."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, valid, world_view,
                full_proj, geom):
        out = _project_forward(means3d, scales, quats, opacities, valid,
                               world_view, full_proj, geom)
        ctx.save_for_backward(means3d, scales, quats, world_view, full_proj)
        ctx.geom = geom
        ctx.mark_non_differentiable(out.radii, out.rect_min, out.rect_max,
                                    out.n_tiles)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, d_means2d, d_conics, d_depths, *_):
        grads = _project_backward(ctx.saved_tensors, ctx.geom, d_means2d,
                                  d_conics, d_depths)
        return (*grads, None, None, None, None, None)


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
    gaussian that misses the band gets radius 0. Differentiable in means3d,
    scales and quats through means2d, conics and depths."""
    n = means3d.shape[0]
    trace.count("proj_gaussians", n)
    if means3d.device.type == "cpu":
        return project_gaussians_plain(
            means3d, scales, quats, world_view, full_proj, tanfovx, tanfovy,
            width, height, tile_size, scale_modifier, valid=valid,
            opacities=opacities, tile_band=tile_band)
    if means3d.device.type != "cuda":
        raise ValueError(f"project_gaussians: unsupported device "
                         f"{means3d.device}")
    trace.count("proj_card_gaussians", n)
    geom = _geometry(tanfovx, tanfovy, width, height, tile_size,
                     scale_modifier, tile_band)
    if torch.is_grad_enabled() and (means3d.requires_grad
                                    or scales.requires_grad
                                    or quats.requires_grad):
        return ProjectedGaussians(*_Projection.apply(
            means3d, scales, quats, opacities, valid, world_view, full_proj,
            geom))
    return _project_forward(means3d, scales, quats, opacities, valid,
                            world_view, full_proj, geom)


def visible_filter(
    means3d: torch.Tensor, scales: torch.Tensor, world_view: torch.Tensor,
    full_proj: torch.Tensor, tanfovx: float, tanfovy: float,
    width: int, height: int, valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Anchor frustum-cull mask (the reference's prefilter_voxel: identity
    rotation, radius>0 test); on a CUDA tensor one launch of the projection
    kernel in its cull mode, which writes the mask alone."""
    global cull_launches
    n = means3d.shape[0]
    trace.count("proj_gaussians", n)
    if means3d.device.type == "cpu":
        return visible_filter_plain(means3d, scales, world_view, full_proj,
                                    tanfovx, tanfovy, width, height,
                                    valid=valid)
    if means3d.device.type != "cuda":
        raise ValueError(f"visible_filter: unsupported device "
                         f"{means3d.device}")
    trace.count("proj_card_gaussians", n)
    args = _forward_args(means3d, scales, None, None, valid, world_view,
                         full_proj)
    mask = torch.empty(n, dtype=torch.bool, device=means3d.device)
    if n:
        geom = _geometry(tanfovx, tanfovy, width, height, 16, 1.0, None)
        _launch("visible_filter",
                c_function(SOURCE, "project_forward", FORWARD_ARGTYPES),
                means3d.device,
                (*args, *geom, OPACITY_MIN, *[None] * 7, mask.data_ptr()))
        cull_launches += 1
    return mask
