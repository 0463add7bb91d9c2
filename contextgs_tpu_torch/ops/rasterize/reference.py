"""Plain PyTorch tile blend: the reference for the CUDA kernel K1 (port of
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
"""

from __future__ import annotations

import torch

from contextgs_tpu_torch.ops.rasterize.common import (T_EPS, alpha_from_power,
                                                      gaussian_power)
from contextgs_tpu_torch.ops.rasterize.projection import ProjectedGaussians
from contextgs_tpu_torch.ops.rasterize.sorting import TileInstances

MAX_ELEMS = 1 << 26    # padded (instance, pixel) pairs per tile group


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


def blend_tiles_reference(rows: torch.Tensor, gauss_ids: torch.Tensor,
                          tile_bounds: torch.Tensor, width: int, height: int,
                          tiles_x: int, tile_size: int = 16,
                          t_eps: float = T_EPS, max_elems: int = MAX_ELEMS,
                          count_pairs: bool = False):
    """rows [G,9] (mean x, y, conic a, b, c, opacity, r, g, b), gauss_ids [B]
    in (tile, depth) order, tile_bounds [n_tiles+1] →
    (rgb [3,H,W], final_T [H,W], last_contrib [H,W] int32).

    `last_contrib` is, per pixel, the 1-based position in its tile's list of
    the last instance blended into it (0 if none). With `count_pairs`, a
    fourth value counts the (pixel, instance) pairs of in-image pixels that a
    front-to-back walk reaches before each pixel is done — the work this data
    needs: `evaluated` (power computed), `exp` (power ≤ 0, so the exp is
    taken), `tested` (alpha ≥ 1/255, so T·(1-α) is tested) and `blended`
    (included in the pixel)."""
    dev = rows.device
    n_tiles = tile_bounds.numel() - 1
    pix = tile_size * tile_size
    tiles_y = n_tiles // tiles_x
    rgb_t = torch.zeros((3, n_tiles, pix), dtype=rows.dtype, device=dev)
    final_t = torch.ones((n_tiles, pix), dtype=rows.dtype, device=dev)
    last_t = torch.zeros((n_tiles, pix), dtype=torch.int32, device=dev)
    pairs = dict(evaluated=0, exp=0, tested=0, blended=0)
    kx = torch.arange(pix, device=dev) % tile_size
    ky = torch.arange(pix, device=dev) // tile_size
    bounds = tile_bounds.to(torch.int64)
    lens = (bounds[1:] - bounds[:-1]).tolist()
    for t0, t1, L in _tile_groups(lens, pix, max_elems):
        if L == 0:
            continue
        t = torch.arange(t0, t1, device=dev)
        pos = torch.arange(L, device=dev)
        valid = pos[None, :] < (bounds[t0 + 1:t1 + 1] - bounds[t0:t1])[:, None]
        idx = torch.where(valid, bounds[t0:t1, None] + pos[None, :], 0)
        r = rows[gauss_ids[idx].to(torch.int64)]              # [nt, L, 9]
        px = ((t % tiles_x) * tile_size)[:, None] + kx[None, :]
        py = ((t // tiles_x) * tile_size)[:, None] + ky[None, :]
        dx = r[..., 0, None] - px[:, None, :].to(rows.dtype)  # [nt, L, pix]
        dy = r[..., 1, None] - py[:, None, :].to(rows.dtype)
        power = gaussian_power(dx, dy, r[..., 2, None], r[..., 3, None],
                               r[..., 4, None])
        alpha = alpha_from_power(power, r[..., 5, None])
        alpha = torch.where(valid[..., None], alpha, 0.0)
        exp_taken = power <= 0.0 if count_pairs else None
        del dx, dy, power

        lg = torch.log1p(-alpha)
        t_before = torch.exp(torch.cumsum(lg, 1) - lg)
        include = t_before * (1.0 - alpha) >= t_eps
        if count_pairs:
            # the walk stops at the first blendable instance that fails
            fail = (alpha > 0) & ~include
            n_eval = torch.where(fail.any(1),
                                 fail.to(torch.int8).argmax(1) + 1,
                                 valid.sum(1, keepdim=True))
            inside = (px < width) & (py < height)
            walked = (pos[None, :, None] < n_eval[:, None, :]) & inside[:, None]
            for key, mask in (("evaluated", walked),
                              ("exp", walked & exp_taken),
                              ("tested", walked & (alpha > 0)),
                              ("blended", walked & (alpha > 0) & include)):
                pairs[key] += int(mask.sum())
            del walked, exp_taken
        alpha = torch.where(include, alpha, 0.0)
        lg = torch.log1p(-alpha)
        w = alpha * torch.exp(torch.cumsum(lg, 1) - lg)        # [nt, L, pix]
        rgb_t[:, t0:t1] = torch.einsum("tlc,tlp->ctp", r[..., 6:9], w)
        final_t[t0:t1] = torch.exp(lg.sum(1))
        last_t[t0:t1] = ((alpha > 0) * (pos + 1)[None, :, None]).amax(1).to(
            torch.int32)

    def untile(x):                                        # [..., n_tiles, pix]
        x = x.reshape(x.shape[:-2] + (tiles_y, tiles_x, tile_size, tile_size))
        x = x.transpose(-3, -2)
        x = x.reshape(x.shape[:-4] + (tiles_y * tile_size, tiles_x * tile_size))
        return x[..., :height, :width]

    out = (untile(rgb_t), untile(final_t), untile(last_t))
    return out + (pairs,) if count_pairs else out


def blend_reference(proj: ProjectedGaussians, inst: TileInstances,
                    colors: torch.Tensor, opacities: torch.Tensor,
                    width: int, height: int, tile_size: int = 16,
                    bg: torch.Tensor | None = None, t_eps: float = T_EPS):
    """(image [3,H,W], final transmittance [H,W]), the JAX signature.

    `t_eps` overrides the early-termination threshold, as in the reference."""
    tiles_x = (width + tile_size - 1) // tile_size
    rows = torch.cat([proj.means2d, proj.conics, opacities[:, None], colors], 1)
    image, final_t, _ = blend_tiles_reference(
        rows, inst.gauss_ids, inst.tile_bounds, width, height, tiles_x,
        tile_size, t_eps)
    if bg is not None:
        image = image + final_t[None] * bg[:, None, None]
    return image, final_t
