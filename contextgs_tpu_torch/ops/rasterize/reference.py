"""Plain PyTorch tile blend and its gradient: the references for the CUDA
kernels K1 and K2 (port of
`contextgs_tpu/ops/rasterize/reference.py::blend_reference`).

Every tile's depth-ordered instance list is laid out as a padded
[tiles, L_max, 256] block, one row per instance and one column per pixel of
the tile. The front-to-back transmittance is the exclusive prefix of
log(1-α) taken by a `cumsum` inside each tile's own rows — a global cumsum
minus the segment head would subtract two large, nearly equal float32
prefixes and lose the precision the T·(1-α) ≥ 1e-4 decision needs. As in the
reference, the include decision is made on a first pass and the recurrence
recomputed with excluded alphas zeroed. Tiles go through in groups whose
padded block stays under `max_elems`, so a full-size frame fits on the card.

The gradient (`blend_tiles_backward_reference`) is autograd through the same
group blend, one group at a time, so its memory is that of one group.

`project_vjp_reference` is the closed-form gradient of the projection
(`projection.project_gaussians`) that its backward kernel
(`csrc/projection.cu`) computes, formula for formula, with the forward's
intermediates recomputed from the inputs.
"""

from __future__ import annotations

import torch

from contextgs_tpu_torch.ops.rasterize.common import (T_EPS, alpha_footprint,
                                                      alpha_from_power,
                                                      gaussian_power)
from contextgs_tpu_torch.ops.rasterize.projection import ProjectedGaussians
from contextgs_tpu_torch.ops.rasterize.sorting import TileInstances

MAX_ELEMS = 1 << 26    # padded (instance, pixel) pairs per tile group
WARP = 32              # pixels of a tile that one warp of K2 walks: 16x2
FWD_WARP = (8, 4)      # the pixels of one warp of K1: wide, tall
PAIR_KEYS = ("evaluated", "exp", "tested", "blended", "fwd_warp_touched",
             "fwd_warp_exp", "bwd_evaluated", "bwd_exp", "bwd_blended",
             "bwd_warp_blended", "bwd_warp_touched", "bwd_tile_blended")


def _tile_groups(lens: list, pix: int, max_elems: int):
    """Consecutive tile ranges [t0, t1) whose padded blocks fit max_elems."""
    t0, l_max = 0, 0
    for t, n in enumerate(lens):
        l_new = max(l_max, n)
        if t > t0 and (t + 1 - t0) * l_new * pix > max_elems:
            yield t0, t, l_max
            t0, l_new = t, n
        l_max = l_new
    if lens:
        yield t0, len(lens), l_max


def _blend_group(rows, gauss_ids, bounds, t0, t1, L, tiles_x, tile_size,
                 width, height, t_eps, pairs, row_offset=0):
    """Blend tiles [t0, t1), lists padded to L → (rgb [3,nt,pix], final_T
    [nt,pix], last_contrib [nt,pix]); adds the group's pair counts to
    `pairs` unless it is None. The tiles are those of a band that starts at
    tile row `row_offset` of the image, `height` rows high."""
    dev = rows.device
    pix = tile_size * tile_size
    kx = torch.arange(pix, device=dev) % tile_size
    ky = torch.arange(pix, device=dev) // tile_size
    t = torch.arange(t0, t1, device=dev)
    pos = torch.arange(L, device=dev)
    valid = pos[None, :] < (bounds[t0 + 1:t1 + 1] - bounds[t0:t1])[:, None]
    idx = torch.where(valid, bounds[t0:t1, None] + pos[None, :], 0)
    r = rows[gauss_ids[idx].to(torch.int64)]              # [nt, L, 9]
    px = ((t % tiles_x) * tile_size)[:, None] + kx[None, :]
    # integer pixel rows of the image, as K1's: the band's offset is added
    # before the coordinate becomes a float
    py = ((t // tiles_x + row_offset) * tile_size)[:, None] + ky[None, :]
    dx = r[..., 0, None] - px[:, None, :].to(rows.dtype)  # [nt, L, pix]
    dy = r[..., 1, None] - py[:, None, :].to(rows.dtype)
    power = gaussian_power(dx, dy, r[..., 2, None], r[..., 3, None],
                           r[..., 4, None])
    alpha = alpha_from_power(power, r[..., 5, None])
    alpha = torch.where(valid[..., None], alpha, 0.0)
    exp_taken = power <= 0.0 if pairs is not None else None
    if pairs is not None:
        # K1's exp prefilter keeps power >= -tau
        tau = alpha_footprint(r[..., 2:5].detach(), r[..., 5].detach())[2]
        exp_kept = exp_taken & ~(power < -tau[..., None])
        del tau
    del dx, dy, power

    with torch.no_grad():
        lg0 = torch.log1p(-alpha)
        t_before = torch.exp(torch.cumsum(lg0, 1) - lg0)
        include = t_before * (1.0 - alpha) >= t_eps
        del lg0, t_before
    if pairs is not None:
        # the walk stops at the first blendable instance that fails
        fail = (alpha > 0) & ~include
        n_eval = torch.where(fail.any(1), fail.to(torch.int8).argmax(1) + 1,
                             valid.sum(1, keepdim=True))
        inside = (px < width) & (py - row_offset * tile_size < height)
        walked = (pos[None, :, None] < n_eval[:, None, :]) & inside[:, None]
        for key, mask in (("evaluated", walked),
                          ("exp", walked & exp_taken),
                          ("tested", walked & (alpha > 0)),
                          ("blended", walked & (alpha > 0) & include)):
            pairs[key] += int(mask.sum())
        touched, exp_warps = _fwd_warp_counts(r.detach(), walked, exp_kept,
                                              px, py, tile_size)
        pairs["fwd_warp_touched"] += touched
        pairs["fwd_warp_exp"] += exp_warps
        del walked, exp_kept
    alpha = torch.where(include, alpha, 0.0)
    lg = torch.log1p(-alpha)
    w = alpha * torch.exp(torch.cumsum(lg, 1) - lg)        # [nt, L, pix]
    rgb = torch.einsum("tlc,tlp->ctp", r[..., 6:9], w)
    final_t = torch.exp(lg.sum(1))
    with torch.no_grad():
        blended = alpha > 0
        last = (blended * (pos + 1)[None, :, None]).amax(1).to(torch.int32)
    if pairs is not None:
        # the backward walks each in-image pixel's list up to last_contrib
        bwd = (pos[None, :, None] < last[:, None, :]) & inside[:, None]
        bwd_blended = bwd & blended
        pairs["bwd_evaluated"] += int(bwd.sum())
        pairs["bwd_exp"] += int((bwd & exp_taken).sum())
        pairs["bwd_blended"] += int(bwd_blended.sum())
        pairs["bwd_warp_blended"] += int(bwd_blended.reshape(
            t1 - t0, L, pix // WARP, WARP).any(-1).sum())
        pairs["bwd_tile_blended"] += int(bwd_blended.any(-1).sum())
        pairs["bwd_warp_touched"] += _warp_touched(
            r.detach(), valid, last * inside, px, py, tile_size)
    return rgb, final_t, last


def _fwd_warp_counts(r, walked, exp_kept, px, py, tile_size):
    """(warp, instance) pairs of K1's walk, warps of FWD_WARP pixels:
    (touched, exp) — touched, those whose `alpha_footprint` box meets the
    warp's pixels at list positions where a pixel of the warp is still
    walking (not yet done, in the image), which K1's compacted lists keep;
    exp, those of them where such a pixel has 0 >= power >= -tau, where the
    warp takes the exp. r [nt, L, 9] rows, walked and exp_kept [nt, L, pix]
    (walked: the pixel walks that position), px, py [nt, pix]."""
    ww, wh = FWD_WARP
    cols, wrows = tile_size // ww, tile_size // wh
    nt, n_pos = walked.shape[:2]
    rx, ry, _ = alpha_footprint(r[..., 2:5], r[..., 5])          # [nt, L]
    x0 = px[:, :1].to(r.dtype) + ww * torch.arange(cols, device=r.device)
    y0 = py[:, :1].to(r.dtype) + wh * torch.arange(wrows, device=r.device)
    mx, my = r[..., 0, None], r[..., 1, None]
    meets_x = (~((mx + rx[..., None]) < x0[:, None])
               & ~((mx - rx[..., None]) > x0[:, None] + (ww - 1)))
    meets_y = (~((my + ry[..., None]) < y0[:, None])
               & ~((my - ry[..., None]) > y0[:, None] + (wh - 1)))
    meets = meets_y[..., :, None] & meets_x[..., None, :]       # [nt, L, r, c]

    def per_warp(mask):
        return mask.reshape(nt, n_pos, wrows, wh, cols, ww).any(-1).any(3)

    touched = meets & per_warp(walked)
    return (int(touched.sum()),
            int((touched & per_warp(walked & exp_kept)).sum()))


def _warp_touched(r, valid, last, px, py, tile_size) -> int:
    """The (warp, instance) pairs whose `alpha_footprint` box meets the
    warp's pixels (WARP of them: whole rows of the tile), at list positions
    before the largest last_contrib of the warp's pixels: those K2 does not
    cull. r [nt, L, 9] rows, valid [nt, L], last [nt, pix] (0 outside the
    image), px, py [nt, pix]."""
    nt, n_warps = last.shape[0], last.shape[1] // WARP
    rx, ry, _ = alpha_footprint(r[..., 2:5], r[..., 5])          # [nt, L]
    x0 = px[:, :1].to(r.dtype)                                   # [nt, 1]
    x1 = x0 + (tile_size - 1)
    y0 = py[:, ::WARP].to(r.dtype)[:, None, :]                   # [nt, 1, w]
    y1 = y0 + (WARP // tile_size - 1)
    mx, my = r[..., 0], r[..., 1]
    meets_x = ~((mx + rx < x0) | (mx - rx > x1)) & valid         # [nt, L]
    meets = (meets_x[..., None] & ~((my + ry)[..., None] < y0)
             & ~((my - ry)[..., None] > y1))                     # [nt, L, w]
    pos = torch.arange(r.shape[1], device=r.device)
    warp_last = last.reshape(nt, n_warps, WARP).amax(-1)         # [nt, w]
    return int((meets & (pos[None, :, None] < warp_last[:, None, :])).sum())


def _tiles_x(width: int, tile_size: int) -> int:
    return (width + tile_size - 1) // tile_size


def _untile(x, tiles_x, tile_size, width, height):
    """[..., n_tiles, pix] → [..., H, W]."""
    tiles_y = x.shape[-2] // tiles_x
    x = x.reshape(x.shape[:-2] + (tiles_y, tiles_x, tile_size, tile_size))
    x = x.transpose(-3, -2)
    x = x.reshape(x.shape[:-4] + (tiles_y * tile_size, tiles_x * tile_size))
    return x[..., :height, :width]


def _tile(x, tiles_x, tiles_y, tile_size):
    """[..., H, W] → [..., n_tiles, pix], zeros past the image's edge."""
    h, w = x.shape[-2:]
    x = torch.nn.functional.pad(x, (0, tiles_x * tile_size - w,
                                    0, tiles_y * tile_size - h))
    x = x.reshape(x.shape[:-2] + (tiles_y, tile_size, tiles_x, tile_size))
    x = x.transpose(-3, -2)
    return x.reshape(x.shape[:-4] + (tiles_y * tiles_x,
                                     tile_size * tile_size))


def blend_tiles_reference(rows: torch.Tensor, gauss_ids: torch.Tensor,
                          tile_bounds: torch.Tensor, width: int, height: int,
                          tiles_x: int, tile_size: int = 16,
                          t_eps: float = T_EPS, max_elems: int = MAX_ELEMS,
                          count_pairs: bool = False, row_offset: int = 0):
    """rows [G,9] (mean x, y, conic a, b, c, opacity, r, g, b), gauss_ids [B]
    in (tile, depth) order, tile_bounds [n_tiles+1] →
    (rgb [3,H,W], final_T [H,W], last_contrib [H,W] int32).

    `last_contrib` is, per pixel, the 1-based position in its tile's list of
    the last instance blended into it (0 if none). With `count_pairs`, a
    fourth value counts the (pixel, instance) pairs of in-image pixels that a
    front-to-back walk reaches before each pixel is done — the work this data
    needs: `evaluated` (power computed), `exp` (power ≤ 0, so the exp is
    taken), `tested` (alpha ≥ 1/255, so T·(1-α) is tested) and `blended`
    (included in the pixel); `fwd_warp_touched`, the (warp, instance) pairs
    that K1's per-warp lists keep (box meets the warp of FWD_WARP pixels, a
    pixel of it still walking), and `fwd_warp_exp`, those of them where the
    warp takes an exp (a walking pixel at 0 >= power >= -tau); and those
    the backward walks, list positions up
    to `last_contrib`: `bwd_evaluated`, `bwd_exp`, `bwd_blended`,
    `bwd_warp_blended`, the (warp of 32 pixels, instance) pairs with at least
    one pixel blended, each of which costs K2 one warp reduction,
    `bwd_tile_blended`, the (tile, instance) pairs with one, each of which
    costs K2 up to nine global atomics, and `bwd_warp_touched`, the (warp,
    instance) pairs before the warp's largest last_contrib that K2's
    footprint cull keeps.

    With `row_offset`, the tiles are the band of tiles from that tile row
    of the image on (the Pallas kernels' `row_offset`), `height` is the
    band's height and the outputs hold the band's rows."""
    dev = rows.device
    n_tiles = tile_bounds.numel() - 1
    pix = tile_size * tile_size
    rgb_t = torch.zeros((3, n_tiles, pix), dtype=rows.dtype, device=dev)
    final_t = torch.ones((n_tiles, pix), dtype=rows.dtype, device=dev)
    last_t = torch.zeros((n_tiles, pix), dtype=torch.int32, device=dev)
    pairs = dict.fromkeys(PAIR_KEYS, 0) if count_pairs else None
    bounds = tile_bounds.to(torch.int64)
    lens = (bounds[1:] - bounds[:-1]).tolist()
    for t0, t1, L in _tile_groups(lens, pix, max_elems):
        if L == 0:
            continue
        rgb_t[:, t0:t1], final_t[t0:t1], last_t[t0:t1] = _blend_group(
            rows, gauss_ids, bounds, t0, t1, L, tiles_x, tile_size, width,
            height, t_eps, pairs, row_offset)
    # contiguous, as the kernel's outputs: K2's wrapper takes only those
    out = tuple(_untile(x, tiles_x, tile_size, width, height).contiguous()
                for x in (rgb_t, final_t, last_t))
    return out + (pairs,) if count_pairs else out


def blend_tiles_backward_reference(rows, gauss_ids, tile_bounds, rgb, final_t,
                                   last_contrib, d_rgb, d_final_t, width: int,
                                   height: int, t_eps: float = T_EPS,
                                   row_offset: int = 0, tile_size: int = 16,
                                   max_elems: int = MAX_ELEMS) -> torch.Tensor:
    """dL/d rows [G,9] of `blend_tiles_reference` for the cotangents d_rgb
    [3,H,W] and d_final_t [H,W]: the plain version of K2, with the same
    signature as `tile_kernel.blend_backward`.

    Autograd through the plain blend, recomputed tile group by tile group;
    the forward's outputs (rgb, final_t, last_contrib) are not read, since
    the recomputation gives them again. Peak memory is about that of one
    group's autograd graph, a few tens of float32 [max_elems] tensors."""
    del rgb, final_t, last_contrib
    n_tiles = tile_bounds.numel() - 1
    tiles_x = _tiles_x(width, tile_size)
    tiles_y = n_tiles // tiles_x
    pix = tile_size * tile_size
    d_rgb_t = _tile(d_rgb, tiles_x, tiles_y, tile_size)
    d_ft_t = _tile(d_final_t, tiles_x, tiles_y, tile_size)
    d_rows = torch.zeros_like(rows)
    bounds = tile_bounds.to(torch.int64)
    lens = (bounds[1:] - bounds[:-1]).tolist()
    with torch.enable_grad():
        for t0, t1, L in _tile_groups(lens, pix, max_elems):
            if L == 0:
                continue
            r = rows.detach().requires_grad_(True)
            rgb_g, ft_g, _ = _blend_group(r, gauss_ids, bounds, t0, t1, L,
                                          tiles_x, tile_size, width, height,
                                          t_eps, None, row_offset)
            s = ((rgb_g * d_rgb_t[:, t0:t1]).sum()
                 + (ft_g * d_ft_t[t0:t1]).sum())
            d_rows += torch.autograd.grad(s, r)[0]
    return d_rows


def blend_reference(proj: ProjectedGaussians, inst: TileInstances,
                    colors: torch.Tensor, opacities: torch.Tensor,
                    width: int, height: int, tile_size: int = 16,
                    bg: torch.Tensor | None = None,
                    tile_row_offset: int = 0,
                    band_height: int | None = None, t_eps: float = T_EPS):
    """(image [3,H,W], final transmittance [H,W]), the JAX signature: with
    a tile band, H is the band height and pixel rows start at
    tile_row_offset·tile_size.

    `t_eps` overrides the early-termination threshold, as in the reference."""
    tiles_x = _tiles_x(width, tile_size)
    if band_height is None:
        band_height = height - tile_row_offset * tile_size
    rows = torch.cat([proj.means2d, proj.conics, opacities[:, None], colors], 1)
    image, final_t, _ = blend_tiles_reference(
        rows, inst.gauss_ids, inst.tile_bounds, width, band_height, tiles_x,
        tile_size, t_eps, row_offset=tile_row_offset)
    if bg is not None:
        image = image + final_t[None] * bg[:, None, None]
    return image, final_t


def _projection_terms(means3d, scales, quats, world_view, full_proj, tanfovx,
                      tanfovy, width, height, scale_modifier=1.0) -> dict:
    """The forward's intermediates that its gradient reads, per gaussian,
    computed op for op as the plain chain computes them
    (`projection.project_gaussians_plain`), so each is the chain's own."""
    tanfovx, tanfovy = float(tanfovx), float(tanfovy)
    fx, fy = width / (2.0 * tanfovx), height / (2.0 * tanfovy)
    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    p4 = torch.cat([means3d, torch.ones_like(means3d[:, :1])], 1)
    v = p4 @ world_view
    clip = p4 @ full_proj
    z = v[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    ux, uy = v[:, 0] / safe_z, v[:, 1] / safe_z
    cx = torch.clamp(ux, -lim_x, lim_x)
    cy = torch.clamp(uy, -lim_y, lim_y)
    tx, ty = cx * z, cy * z
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    rv = world_view[:3, :3].T
    fxi, fyi = fx * inv_z, fy * inv_z
    gx, gy = -fx * tx * inv_z2, -fy * ty * inv_z2
    T = [[fxi * rv[0, j] + gx * rv[2, j] for j in range(3)],
         [fyi * rv[1, j] + gy * rv[2, j] for j in range(3)]]
    w, x, y, zq = quats.unbind(1)
    R = [[1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq),
          2 * (x * zq + w * y)],
         [2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq),
          2 * (y * zq - w * x)],
         [2 * (x * zq - w * y), 2 * (y * zq + w * x),
          1 - 2 * (x * x + y * y)]]
    s = [scales[:, j] * scale_modifier for j in range(3)]
    M = [[R[r][j] * s[j] for j in range(3)] for r in range(3)]
    C = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for q in range(r, 3):
            C[r][q] = C[q][r] = (M[r][0] * M[q][0] + M[r][1] * M[q][1]
                                 + M[r][2] * M[q][2])

    def quad(ta, tb):
        return (ta[0] * tb[0] * C[0][0] + ta[1] * tb[1] * C[1][1]
                + ta[2] * tb[2] * C[2][2]
                + (ta[0] * tb[1] + ta[1] * tb[0]) * C[0][1]
                + (ta[0] * tb[2] + ta[2] * tb[0]) * C[0][2]
                + (ta[1] * tb[2] + ta[2] * tb[1]) * C[1][2])

    a = quad(T[0], T[0]) + 0.3
    b = quad(T[0], T[1])
    c = quad(T[1], T[1]) + 0.3

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    return dict(v=v, clip=clip, z=z, safe_z=safe_z, ux=ux, uy=uy, cx=cx,
                cy=cy, tx=tx, ty=ty, inv_z=inv_z, inv_z2=inv_z2, T=mat(T),
                q=quats, R=mat(R), s=torch.stack(s, 1), M=mat(M), C=mat(C),
                a=a, b=b, c=c, det=a * c - b * b,
                pw=1.0 / (clip[:, 3] + 1e-7), fx=fx, fy=fy, lim_x=lim_x,
                lim_y=lim_y)


def project_vjp_reference(means3d, scales, quats, world_view, full_proj,
                          tanfovx, tanfovy, width, height, d_means2d,
                          d_conics, d_depths=None, scale_modifier=1.0):
    """The gradient of `project_gaussians`' means2d [G,2], conics [G,3] and
    depths [G] with respect to means3d [G,3], scales [G,3] and quats [G,4],
    given their cotangents (any may be None): the backward kernel's formulas
    in plain PyTorch. As autograd of the plain chain: a clamp passes the
    gradient only inside its bounds (included), a where() only to the branch
    it chose (safe z, safe det); the rect, radius and opacity paths carry
    none."""
    e = _projection_terms(means3d, scales, quats, world_view, full_proj,
                          tanfovx, tanfovy, width, height, scale_modifier)
    zero = torch.zeros_like(e["z"])
    T, C, M, R = e["T"], e["C"], e["M"], e["R"]
    g_v = [zero, zero, zero]
    g_s = torch.zeros_like(scales)
    g_q = torch.zeros_like(quats)
    if d_conics is not None:
        gA, gB, gC = d_conics.unbind(1)
        det_ok = e["det"] > 0
        inv_det = 1.0 / torch.where(det_ok, e["det"], 1.0)
        ga, gb, gc = gC * inv_det, -(gB * inv_det), gA * inv_det
        g_inv = gA * e["c"] - gB * e["b"] + gC * e["a"]
        g_det = torch.where(det_ok, -g_inv * (inv_det * inv_det), 0.0)
        ga = ga + g_det * e["c"]
        gc = gc + g_det * e["a"]
        gb = gb - 2.0 * (g_det * e["b"])
        CT = T @ C                    # rows (C T_r)^T, C symmetric
        gT = torch.stack([2.0 * ga[:, None] * CT[:, 0] + gb[:, None] * CT[:, 1],
                          gb[:, None] * CT[:, 0] + 2.0 * gc[:, None] * CT[:, 1]],
                         1)
        # d quad / d Sigma as a symmetric matrix counting each unique entry
        # once: off-diagonal entries get both orders of the pair
        T0, T1 = T[:, 0], T[:, 1]
        outer = (ga[:, None, None] * T0[:, :, None] * T0[:, None, :]
                 + gb[:, None, None] * 0.5 * (T0[:, :, None] * T1[:, None, :]
                                              + T1[:, :, None] * T0[:, None, :])
                 + gc[:, None, None] * T1[:, :, None] * T1[:, None, :])
        gSigma = 2.0 * outer              # Gs: 2 gC_kk on the diagonal, gC_kl off it
        gM = gSigma @ M
        gR = gM * e["s"][:, None, :]
        g_s = (gM * R).sum(1) * scale_modifier
        w, x, y, z = e["q"].unbind(1)
        r = gR.reshape(-1, 9).unbind(1)
        g_q = 2.0 * torch.stack([
            -z * r[1] + y * r[2] + z * r[3] - x * r[5] - y * r[6] + x * r[7],
            y * r[1] + z * r[2] + y * r[3] - 2.0 * x * r[4] - w * r[5]
            + z * r[6] + w * r[7] - 2.0 * x * r[8],
            -2.0 * y * r[0] + x * r[1] + w * r[2] + x * r[3] + z * r[5]
            - w * r[6] + z * r[7] - 2.0 * y * r[8],
            -2.0 * z * r[0] - w * r[1] + x * r[2] + w * r[3] - 2.0 * z * r[4]
            + y * r[5] + x * r[6] + y * r[7]], 1)
        wv = world_view[:3, :3]
        g_fxi = gT[:, 0] @ wv[:, 0]
        g_gx = gT[:, 0] @ wv[:, 2]
        g_fyi = gT[:, 1] @ wv[:, 1]
        g_gy = gT[:, 1] @ wv[:, 2]
        fx, fy, inv_z = e["fx"], e["fy"], e["inv_z"]
        g_tx = g_gx * (-fx) * e["inv_z2"]
        g_ty = g_gy * (-fy) * e["inv_z2"]
        g_inv_z2 = g_gx * (-fx * e["tx"]) + g_gy * (-fy * e["ty"])
        g_inv_z = g_fxi * fx + g_fyi * fy + 2.0 * (g_inv_z2 * inv_z)
        g_safe_z = -g_inv_z * (inv_z * inv_z)
        g_z = g_tx * e["cx"] + g_ty * e["cy"]
        ux, uy, safe_z = e["ux"], e["uy"], e["safe_z"]
        g_ux = torch.where((ux >= -e["lim_x"]) & (ux <= e["lim_x"]),
                           g_tx * e["z"], 0.0)
        g_uy = torch.where((uy >= -e["lim_y"]) & (uy <= e["lim_y"]),
                           g_ty * e["z"], 0.0)
        g_safe_z = (g_safe_z - g_ux * ((e["v"][:, 0] / safe_z) / safe_z)
                    - g_uy * ((e["v"][:, 1] / safe_z) / safe_z))
        g_z = g_z + torch.where(torch.abs(e["z"]) < 1e-6, 0.0, g_safe_z)
        g_v = [g_ux / safe_z, g_uy / safe_z, g_z]
    if d_depths is not None:
        g_v[2] = g_v[2] + d_depths
    g_clip = [zero, zero, zero, zero]
    if d_means2d is not None:
        g_p0 = d_means2d[:, 0] * (0.5 * width)
        g_p1 = d_means2d[:, 1] * (0.5 * height)
        pw, clip = e["pw"], e["clip"]
        g_pw = g_p0 * clip[:, 0] + g_p1 * clip[:, 1]
        g_clip = [g_p0 * pw, g_p1 * pw, zero, -g_pw * (pw * pw)]
    g_means = (torch.stack(g_v, 1) @ world_view[:3, :3].T
               + torch.stack(g_clip, 1) @ full_proj[:3, :].T)
    return g_means, g_s, g_q
