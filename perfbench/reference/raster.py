"""The 3D Gaussian Splatting rasterizer of the plain reference, written from
the semantics of 3DGS's CUDA rasterizer (`diff-gaussian-rasterization`, as
the JAX package of this repository states them), in plain PyTorch and
differentiated by autograd alone.

- Projection: EWA splatting of each gaussian's covariance, with the view
  frustum clamped at 1.3·tan(fov) inside the Jacobian, 0.3 added to the
  2D covariance's diagonal, radius ceil(3·sqrt(largest eigenvalue)), and a
  tile rect (16-pixel tiles) around the mean whose half-extents are the
  box of the alpha ≥ 1/255 ellipse, at most the radius; gaussians nearer
  than 0.2 are culled.
- Binning: one instance per (gaussian, tile of its rect), each tile's
  instances in depth order, ties by gaussian index.
- Blend: each pixel takes its tile's instances front to back with
  alpha = min(0.99, opacity·exp(power)), skipping alpha < 1/255 and
  stopping before the first instance after which the transmittance would
  fall under 1e-4; the background takes the rest.

Tiles go through in groups whose padded [tiles, instances, 256] block
stays under `MAX_ELEMS`; in training each group is recomputed in the
backward (`torch.utils.checkpoint`), so memory is that of one group.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
Z_NEAR_CULL = 0.2
MAX_ELEMS = 1 << 26
CAMERA_ZNEAR, CAMERA_ZFAR = 0.01, 100.0


def camera(R: np.ndarray, T: np.ndarray, fov_x: float, fov_y: float,
           device) -> dict:
    """A camera's transforms (3DGS's getWorld2View2 and getProjectionMatrix,
    both transposed for row vectors) and centre, from its camera-to-world
    rotation R, world-to-camera translation T and fields of view."""
    w2v = np.zeros((4, 4))
    w2v[:3, :3] = np.asarray(R).T
    w2v[:3, 3] = T
    w2v[3, 3] = 1.0
    tan_x, tan_y = math.tan(fov_x / 2), math.tan(fov_y / 2)
    n, f = CAMERA_ZNEAR, CAMERA_ZFAR
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / tan_x
    proj[1, 1] = 1.0 / tan_y
    proj[3, 2] = 1.0
    proj[2, 2] = f / (f - n)
    proj[2, 3] = -(f * n) / (f - n)
    world_view = w2v.T.astype(np.float32)
    full_proj = (world_view @ proj.T.astype(np.float32)).astype(np.float32)
    center = np.linalg.inv(world_view)[3, :3].astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return dict(world_view=t(world_view), full_proj=t(full_proj),
                center=t(center), tanfovx=float(np.float32(tan_x)),
                tanfovy=float(np.float32(tan_y)))


class Splats(NamedTuple):
    means2d: torch.Tensor      # [G,2] pixel coordinates
    conics: torch.Tensor       # [G,3] inverse 2D covariance (a, b, c)
    depths: torch.Tensor       # [G] view-space z
    rect_min: torch.Tensor     # [G,2] first tile (x, y), inclusive
    rect_max: torch.Tensor     # [G,2] last tile (x, y), exclusive
    keep: torch.Tensor         # [G] bool: touches at least one tile


def project(means, scales, quats, cam: dict, width: int, height: int,
            valid=None, opacities=None) -> Splats:
    n = means.shape[0]
    hom = torch.cat([means, torch.ones((n, 1), dtype=means.dtype,
                                       device=means.device)], dim=1)
    p_view = hom @ cam["world_view"]
    z = p_view[:, 2]
    p_clip = hom @ cam["full_proj"]
    p_proj = p_clip[:, :3] / (p_clip[:, 3:4] + 1e-7)
    tanx, tany = cam["tanfovx"], cam["tanfovy"]
    fx, fy = width / (2.0 * tanx), height / (2.0 * tany)
    safe_z = torch.where(z.abs() < 1e-6, 1e-6, z)
    tx = torch.clamp(p_view[:, 0] / safe_z, -1.3 * tanx, 1.3 * tanx) * z
    ty = torch.clamp(p_view[:, 1] / safe_z, -1.3 * tany, 1.3 * tany) * z
    # the Jacobian of the perspective map at the (clamped) view point
    j00, j02 = fx / safe_z, -fx * tx / (safe_z * safe_z)
    j11, j12 = fy / safe_z, -fy * ty / (safe_z * safe_z)
    rv = cam["world_view"][:3, :3].T            # world → view rotation
    zero = torch.zeros_like(j00)
    jac = torch.stack([torch.stack([j00, zero, j02], -1),
                       torch.stack([zero, j11, j12], -1)], -2)   # [G,2,3]
    t = jac @ rv                                                  # [G,2,3]
    w, x, y, q3 = quats.unbind(-1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + q3 * q3), 2 * (x * y - w * q3),
                     2 * (x * q3 + w * y)], -1),
        torch.stack([2 * (x * y + w * q3), 1 - 2 * (x * x + q3 * q3),
                     2 * (y * q3 - w * x)], -1),
        torch.stack([2 * (x * q3 - w * y), 2 * (y * q3 + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)          # [G,3,3]
    m = rot * scales[:, None, :]
    sigma = m @ m.transpose(1, 2)                                 # R S² Rᵀ
    cov = t @ sigma @ t.transpose(1, 2)                           # [G,2,2]
    a = cov[:, 0, 0] + 0.3
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det > 0
    inv = 1.0 / torch.where(det_ok, det, 1.0)
    conics = torch.stack([c * inv, -b * inv, a * inv], -1)
    means2d = torch.stack([((p_proj[:, 0] + 1.0) * width - 1.0) * 0.5,
                           ((p_proj[:, 1] + 1.0) * height - 1.0) * 0.5], -1)
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(lam))
        if opacities is not None:
            k = torch.sqrt(torch.clamp(2.0 * torch.log(torch.clamp(
                255.0 * opacities, min=1e-30)), min=0.0))
            rx = torch.minimum(torch.ceil(k * torch.sqrt(a.clamp(min=0))),
                               radius)
            ry = torch.minimum(torch.ceil(k * torch.sqrt(c.clamp(min=0))),
                               radius)
        else:
            rx = ry = radius
        tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
        mx, my = means2d[:, 0], means2d[:, 1]
        rect_min = torch.stack([
            ((mx - rx) / TILE).to(torch.int32).clamp(0, tiles_x),
            ((my - ry) / TILE).to(torch.int32).clamp(0, tiles_y)], -1)
        rect_max = torch.stack([
            ((mx + rx + TILE - 1) / TILE).to(torch.int32).clamp(0, tiles_x),
            ((my + ry + TILE - 1) / TILE).to(torch.int32).clamp(0, tiles_y)],
            -1)
        keep = det_ok & (z > Z_NEAR_CULL)
        if opacities is not None:
            keep = keep & (opacities >= ALPHA_MIN)
        if valid is not None:
            keep = keep & valid
        area = ((rect_max[:, 0] - rect_min[:, 0])
                * (rect_max[:, 1] - rect_min[:, 1]))
        keep = keep & (area > 0)
    return Splats(means2d, conics, z, rect_min, rect_max, keep)


def visible(anchors, scales, cam: dict, width: int, height: int,
            valid=None) -> torch.Tensor:
    """[N] bool: the anchors that touch a tile when projected as gaussians
    of their first three scales and no rotation."""
    quats = torch.zeros((anchors.shape[0], 4), dtype=anchors.dtype,
                        device=anchors.device)
    quats[:, 0] = 1.0
    with torch.no_grad():
        return project(anchors, scales, quats, cam, width, height,
                       valid=valid).keep


def instances(s: Splats, width: int) -> tuple:
    """(gaussian ids [B], tile ids [B]) of every (gaussian, tile of its
    rect) pair, in (tile, depth, gaussian) order."""
    tiles_x = -(-width // TILE)
    g = torch.nonzero(s.keep).squeeze(1)
    w = (s.rect_max[g, 0] - s.rect_min[g, 0]).to(torch.int64)
    h = (s.rect_max[g, 1] - s.rect_min[g, 1]).to(torch.int64)
    count = w * h
    ids = torch.repeat_interleave(g, count)
    start = torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
    k = torch.arange(ids.numel(), device=ids.device) - start
    wi = torch.repeat_interleave(w, count)
    tile = ((s.rect_min[ids, 1].to(torch.int64) + k // wi) * tiles_x
            + s.rect_min[ids, 0].to(torch.int64) + k % wi)
    by_depth = torch.sort(s.depths.detach()[ids], stable=True).indices
    ids, tile = ids[by_depth], tile[by_depth]
    by_tile = torch.sort(tile, stable=True).indices
    ids, tile = ids[by_tile], tile[by_tile]
    return ids, tile


def _groups(lens: list, max_elems: int):
    t0, longest = 0, 0
    for t, n in enumerate(lens):
        if t > t0 and (t + 1 - t0) * max(longest, n) * PIX > max_elems:
            yield t0, t, longest
            t0, longest = t, 0
        longest = max(longest, n)
    if lens:
        yield t0, len(lens), longest


def _blend_block(means2d, conics, opacity, color, ids, pad, px, py,
                 counts: dict | None):
    """One group: ids [nt, L] (pad where `pad`), pixel coordinates px, py
    [nt, 256] → (rgb [3, nt, 256], transmittance [nt, 256])."""
    dx = means2d[ids, 0][..., None] - px[:, None, :]
    dy = means2d[ids, 1][..., None] - py[:, None, :]
    con = conics[ids]
    power = (-0.5 * (con[..., 0, None] * dx * dx + con[..., 2, None] * dy * dy)
             - con[..., 1, None] * dx * dy)
    alpha0 = torch.clamp(opacity[ids][..., None] * torch.exp(power),
                         max=ALPHA_MAX)
    alpha0 = torch.where((power > 0) | (alpha0 < ALPHA_MIN) | pad[..., None],
                         0.0, alpha0)
    with torch.no_grad():
        include = torch.cumprod(1.0 - alpha0, dim=1) >= T_MIN
    alpha = torch.where(include, alpha0, 0.0)
    through = torch.cumprod(1.0 - alpha, dim=1)
    before = torch.cat([torch.ones_like(through[:, :1]), through[:, :-1]], 1)
    rgb = torch.einsum("tlc,tlp->ctp", color[ids], alpha * before)
    if counts is not None:
        with torch.no_grad():
            blended = (alpha > 0).sum(1)
            ended = ((alpha0 > 0) & ~include).any(1)
            inside = counts["inside"]
            counts["blended"] += int((blended * inside).sum())
            counts["tested"] += int(((blended + ended) * inside).sum())
    return rgb, through[:, -1]


def blend(means2d, conics, opacity, color, ids, bounds, width: int,
          height: int, counts: dict | None = None) -> tuple:
    """(rgb [3,H,W], final transmittance [H,W]) of the tiles' instance
    lists: `ids` [B] gaussian indices in (tile, depth) order and `bounds`
    [tiles+1] each tile's range in them. With `counts` ({} or a dict),
    adds the (pixel, instance) pairs of pixels inside the image: `blended`,
    those that blend, and `tested`, those plus each pixel's instance that
    ended its walk."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    dev = means2d.device
    ids = ids.to(torch.int64)
    bounds = bounds.to(torch.int64)
    lens = (bounds[1:] - bounds[:-1]).tolist()
    kx = torch.arange(PIX, device=dev) % TILE
    ky = torch.arange(PIX, device=dev) // TILE
    if counts is not None:
        counts.setdefault("blended", 0)
        counts.setdefault("tested", 0)
    rgb_t = torch.zeros((3, tiles_x * tiles_y, PIX), dtype=means2d.dtype,
                        device=dev)
    t_t = torch.ones((tiles_x * tiles_y, PIX), dtype=means2d.dtype,
                     device=dev)
    parts, trans, spans = [], [], []
    for t0, t1, longest in _groups(lens, MAX_ELEMS):
        if longest == 0:
            continue
        t = torch.arange(t0, t1, device=dev)
        pos = torch.arange(longest, device=dev)
        pad = pos[None, :] >= (bounds[t0 + 1:t1 + 1] - bounds[t0:t1])[:, None]
        block = torch.where(pad, 0, ids[torch.clamp(
            bounds[t0:t1, None] + pos[None, :], max=max(ids.numel() - 1, 0))])
        px = ((t % tiles_x) * TILE)[:, None] + kx[None, :]
        py = ((t // tiles_x) * TILE)[:, None] + ky[None, :]
        if counts is not None:
            counts["inside"] = (px < width) & (py < height)
        args = (means2d, conics, opacity, color, block, pad,
                px.to(means2d.dtype), py.to(means2d.dtype))
        if torch.is_grad_enabled() and counts is None:
            rgb, tr = checkpoint(_blend_block, *args, None,
                                 use_reentrant=False)
        else:
            rgb, tr = _blend_block(*args, counts)
        parts.append(rgb)
        trans.append(tr)
        spans.append((t0, t1))
    if counts is not None:
        counts.pop("inside", None)
    if spans:
        rows = torch.cat([torch.arange(a, b, device=dev) for a, b in spans])
        rgb_t = rgb_t.index_copy(1, rows, torch.cat(parts, 1))
        t_t = t_t.index_copy(0, rows, torch.cat(trans, 0))

    def untile(x):
        x = x.reshape(x.shape[:-2] + (tiles_y, tiles_x, TILE, TILE))
        x = x.transpose(-3, -2).reshape(x.shape[:-4] + (tiles_y * TILE,
                                                        tiles_x * TILE))
        return x[..., :height, :width]

    return untile(rgb_t), untile(t_t)


def tile_bounds(tile: torch.Tensor, n_tiles: int) -> torch.Tensor:
    out = torch.zeros(n_tiles + 1, dtype=torch.int64, device=tile.device)
    out[1:] = torch.cumsum(torch.bincount(tile, minlength=n_tiles), 0)
    return out


def rasterize(means, scales, quats, colors, opacities, cam: dict,
              width: int, height: int, bg: torch.Tensor, valid=None):
    """The image [3,H,W] of the gaussians over the background."""
    s = project(means, scales, quats, cam, width, height, valid=valid,
                opacities=opacities.detach())
    ids, tile = instances(s, width)
    n_tiles = -(-width // TILE) * -(-height // TILE)
    rgb, final_t = blend(s.means2d, s.conics, opacities, colors, ids,
                         tile_bounds(tile, n_tiles), width, height)
    return rgb + final_t[None] * bg[:, None, None]
