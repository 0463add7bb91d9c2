"""The port's CUDA kernels K1 (tile-blend forward), K2 (its backward), K3
(the lane prefix sum), K4 (the forward's five stages), K5/K6 (the slab
transposes), the projection's three (forward, cull, backward), the tile
binning's two passes, Adam's and the segmented carry's against their plain
versions, the codec's
CDF rows against theirs, and the codec's round trip on the card.

This file imports neither JAX nor the JAX package, so that it also runs on
the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Tests marked `cuda` skip without a card.
"""

import os
import re
from fractions import Fraction

import numpy as np
import pytest
import torch
from scipy.special import ndtr
from torch.profiler import ProfilerActivity, profile

from contextgs_tpu_torch.compression import cdf_rows as tcdf
from contextgs_tpu_torch.compression import codec as tcodec
from contextgs_tpu_torch.compression import coder as tcoder
from contextgs_tpu_torch.config import ModelConfig, OptimizationConfig
from contextgs_tpu_torch.models import levels as tlev
from contextgs_tpu_torch.models import state as tst
from contextgs_tpu_torch.ops import carry as tcarry
from contextgs_tpu_torch.ops import rasterize as trz
from contextgs_tpu_torch.ops import scan as tscan
from contextgs_tpu_torch.ops.rasterize import projection as tproj
from contextgs_tpu_torch.ops.rasterize import reference as tref
from contextgs_tpu_torch.ops.rasterize import sorting as tsort
from contextgs_tpu_torch.ops.rasterize import tile_kernel
from contextgs_tpu_torch.ops.rasterize.common import (ALPHA_EPS,
                                                      alpha_footprint,
                                                      alpha_from_power,
                                                      gaussian_power)
from contextgs_tpu_torch.scene.cameras import make_camera
from contextgs_tpu_torch.scripts import kvariants as tkv
from contextgs_tpu_torch.scripts import xpose_lab as txl
from contextgs_tpu_torch.train import loop as tloop
from contextgs_tpu_torch.train import optim as toptim
from contextgs_tpu_torch.utils import trace

import carry_cases
import projection_cases

torch.set_num_threads(1)

W, H = 48, 32
TILES_X = 3


def _random_rows(rng, n_tiles_x, n_tiles_y, n):
    """Random splat rows and their (tile, depth) lists: each instance is a
    random gaussian in a random tile, in list order."""
    rows = np.zeros((n, 9), np.float32)
    rows[:, 0] = rng.uniform(-4, 16 * n_tiles_x + 4, n)
    rows[:, 1] = rng.uniform(-4, 16 * n_tiles_y + 4, n)
    a = rng.uniform(0.005, 0.5, n)
    c = rng.uniform(0.005, 0.5, n)
    b = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    rows[:, 2:5] = np.stack([a, b, c], 1)
    rows[:, 5] = rng.uniform(0.05, 1.0, n)
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    n_tiles = n_tiles_x * n_tiles_y
    tiles = np.sort(rng.integers(0, n_tiles, 4 * n))
    ids = rng.integers(0, n, tiles.size).astype(np.int32)
    bounds = np.searchsorted(tiles, np.arange(n_tiles + 1)).astype(np.int32)
    return rows, ids, bounds


def _chunk_boundary_rows():
    """One tile, 384 centred slots with conic 1e-4: slots 0-2 finish the
    pixel, slot 256 is bright green and must not blend (G = 0)."""
    rows = np.zeros((384, 9), np.float32)
    rows[:, 0:2] = 7.5
    rows[:, 2] = rows[:, 4] = 1e-4
    rows[:3, 5] = [0.99, 0.98, 0.99]
    rows[:3, 6] = 1.0
    rows[256, 5] = 0.3
    rows[256, 7] = 1000.0
    return rows, np.arange(384, dtype=np.int32), np.int32([0, 384])


def _blend(rows, ids, bounds, width, height, device):
    return tile_kernel.blend_forward(
        torch.from_numpy(rows).to(device), torch.from_numpy(ids).to(device),
        torch.from_numpy(bounds).to(device), width, height)


def test_blend_forward_cpu_takes_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; last_contrib marks the last blended instance per pixel."""
    rng = np.random.default_rng(0)
    rows, ids, bounds = _random_rows(rng, TILES_X, 2, 200)
    before = tile_kernel.launches
    rgb, ft, last = _blend(rows, ids, bounds, W, H, "cpu")
    assert tile_kernel.launches == before
    lens = np.diff(bounds)
    tile_of = (np.arange(H)[:, None] // 16) * TILES_X + np.arange(W)[None] // 16
    last = last.numpy()
    assert (last >= 0).all() and (last <= lens[tile_of]).all()
    assert ((last == 0) == (ft.numpy() == 1.0)).all()
    assert ft.numpy().min() < 0.01 and rgb.shape == (3, H, W)

    rgb, ft, last = _blend(*_chunk_boundary_rows(), 16, 16, "cpu")
    assert (rgb[1] == 0).all() and (last == 2).all()  # the third is excluded


@pytest.mark.parametrize("max_elems", [1, 256 * 300, 256 * 2000])
def test_plain_version_tile_groups_agree(max_elems):
    """Tiles blended in small groups give what one group gives."""
    rng = np.random.default_rng(2)
    rows, ids, bounds = (torch.from_numpy(x)
                         for x in _random_rows(rng, TILES_X, 2, 200))
    whole = tref.blend_tiles_reference(rows, ids, bounds, W, H, TILES_X,
                                       count_pairs=True)
    split = tref.blend_tiles_reference(rows, ids, bounds, W, H, TILES_X,
                                       max_elems=max_elems, count_pairs=True)
    for a, b in zip(whole[:2], split[:2]):     # padding may reorder sums
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_array_equal(whole[2].numpy(), split[2].numpy())
    assert whole[3] == split[3]
    c = whole[3]
    assert 0 < c["blended"] <= c["tested"] <= c["exp"] <= c["evaluated"]
    assert c["evaluated"] <= 256 * len(ids)


def _walk_counts(rows, ids, bounds, w, h, tiles_x):
    """Pair counts and last_contrib of a per-pixel front-to-back walk (the
    loop K1 runs) in float64; a per-warp loop over the lists for the (warp,
    instance) pairs that K1's per-warp lists keep; and the backward's
    counts: its per-pixel replay up to last_contrib, and a per-warp loop
    over the list for the (warp, instance) pairs that K2's footprint cull
    keeps."""
    want = dict.fromkeys(tref.PAIR_KEYS, 0)
    warp_blended = set()                # (tile, warp, list position)
    last = np.zeros((h, w), np.int64)
    walk_len = np.zeros((h, w), np.int64)     # list positions walked
    r = rows.astype(np.float64)
    for y in range(h):
        for x in range(w):
            tile = (y // 16) * tiles_x + x // 16
            T, n_last, walk = 1.0, 0, []
            for k in range(bounds[tile], bounds[tile + 1]):
                mx, my, a, b, cc, op = r[ids[k], :6]
                dx, dy = mx - x, my - y
                power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
                want["evaluated"] += 1
                walk.append("evaluated")
                if power > 0:
                    continue
                want["exp"] += 1
                walk[-1] = "exp"
                alpha = min(0.99, op * np.exp(power))
                if alpha < 1 / 255:
                    continue
                want["tested"] += 1
                if T * (1 - alpha) < 1e-4:
                    break
                want["blended"] += 1
                walk[-1] = "blended"
                T *= 1 - alpha
                n_last = k - bounds[tile] + 1
            last[y, x] = n_last
            walk_len[y, x] = len(walk)
            # the backward replays the list up to last_contrib
            for pos, how in enumerate(walk[:n_last]):
                want["bwd_evaluated"] += 1
                want["bwd_exp"] += how != "evaluated"
                if how == "blended":
                    want["bwd_blended"] += 1
                    warp_blended.add((tile, ((y % 16) * 16 + x % 16) // 32,
                                      pos))
    want["bwd_warp_blended"] = len(warp_blended)
    want["bwd_tile_blended"] = len({(t, pos) for t, _, pos in warp_blended})
    rx, ry, tau = (v.numpy() for v in alpha_footprint(
        torch.from_numpy(rows[:, 2:5]), torch.from_numpy(rows[:, 5])))
    f32 = np.float32
    fw, fh = tref.FWD_WARP
    for tile in range(len(bounds) - 1):
        x0, y0 = (tile % tiles_x) * 16, (tile // tiles_x) * 16
        for wy, wx in ((wy, wx) for wy in range(y0, y0 + 16, fh)
                       for wx in range(x0, x0 + 16, fw)):
            pixels = [(y, x) for y in range(wy, min(wy + fh, h))
                      for x in range(wx, min(wx + fw, w))]
            for pos in range(bounds[tile + 1] - bounds[tile]):
                walking = [(y, x) for y, x in pixels if pos < walk_len[y, x]]
                g = ids[bounds[tile] + pos]
                mx, my = rows[g, 0], rows[g, 1]
                if not walking or (mx + rx[g] < f32(wx)
                                   or mx - rx[g] > f32(wx + fw - 1)
                                   or my + ry[g] < f32(wy)
                                   or my - ry[g] > f32(wy + fh - 1)):
                    continue
                want["fwd_warp_touched"] += 1
                a, b, cc = rows[g, 2:5]
                powers = []
                for y, x in walking:     # gaussian_power's float32 order
                    dx, dy = mx - f32(x), my - f32(y)
                    powers.append(f32(-0.5) * (a * dx * dx + cc * dy * dy)
                                  - b * dx * dy)
                want["fwd_warp_exp"] += any(-tau[g] <= p <= 0 for p in powers)
    for tile in range(len(bounds) - 1):
        x0, y0 = (tile % tiles_x) * 16, (tile // tiles_x) * 16
        for warp in range(8):
            ys = [y0 + 2 * warp, y0 + 2 * warp + 1]
            walked = max([last[y, x] for y in ys if y < h
                          for x in range(x0, min(x0 + 16, w))], default=0)
            for pos in range(walked):
                g = ids[bounds[tile] + pos]
                mx, my = rows[g, 0], rows[g, 1]
                misses = (mx + rx[g] < f32(x0) or mx - rx[g] > f32(x0 + 15)
                          or my + ry[g] < f32(ys[0])
                          or my - ry[g] > f32(ys[1]))
                want["bwd_warp_touched"] += not misses
    return want, last


def test_plain_version_pair_counts_match_a_walk():
    """The pair counts equal those of a per-pixel front-to-back walk, the
    loop K1 runs, and `last_contrib` is where each walk last blended."""
    rng = np.random.default_rng(3)
    rows, ids, bounds = _random_rows(rng, 2, 1, 40)
    w, h = 30, 12                                 # a ragged edge tile
    _, _, last, got = tref.blend_tiles_reference(
        *(torch.from_numpy(x) for x in (rows, ids, bounds)), w, h, 2,
        count_pairs=True)
    want, want_last = _walk_counts(rows, ids, bounds, w, h, 2)
    np.testing.assert_array_equal(last.numpy(), want_last)
    assert got == want


def _cull_rows(rng, case, n, width=48, height=32):
    """Splat rows [n, 9] that probe K2's footprint cull: `edge` puts the
    edge of each splat's alpha >= 1/255 region, and of its box, on a warp's
    row boundary (between rows 2k+1 and 2k+2) or a tile's column boundary;
    `faint` has opacities just above 1/255 (some means on pixel centres);
    `not_pd` has conics with det <= 0 or a <= 0, some of them negative
    definite, which blend nowhere, some indefinite."""
    rows = np.zeros((n, 9), np.float32)
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    a = rng.uniform(0.01, 0.6, n)
    c = rng.uniform(0.01, 0.6, n)
    b = rng.uniform(-0.95, 0.95, n) * np.sqrt(a * c)
    op = rng.uniform(0.05, 1.0, n)
    mx = rng.uniform(0, width, n)
    my = rng.uniform(0, height, n)
    if case == "edge":
        tau = np.log(255 * op)
        det = a * c - b * b
        ry_exact = np.sqrt(2 * tau * a / det)
        rx_exact = np.sqrt(2 * tau * c / det)
        boundary = 2 * rng.integers(1, height // 2 - 1, n) - 0.5
        half = n // 2
        # the exact region's edge on the boundary, then the box's edge (the
        # exact half-extent plus about one pixel of margin) on a row
        my[:half] = boundary[:half] - ry_exact[:half] * rng.choice([-1, 1],
                                                                   half)
        my[half:] = np.round(boundary[half:] + 0.5) - ry_exact[half:] - 1
        mx[::3] = 16 * rng.integers(1, width // 16, mx[::3].size) - 0.5 \
            - rx_exact[::3]
    elif case == "faint":
        op = (1 / 255) * (1 + rng.choice([1e-6, 1e-5, 1e-3, 1e-1], n))
        mx[::2] = np.round(mx[::2])
        my[::2] = np.round(my[::2])
    else:           # small enough that exp(power) stays finite
        a, c = rng.uniform(0.001, 0.015, n), rng.uniform(0.001, 0.015, n)
        b = rng.choice([-1, 1], n) * np.sqrt(a * c) * rng.uniform(1.0, 1.5, n)
        a[::4] = -a[::4]
        c[1::4] = -c[1::4]
    rows[:, 0], rows[:, 1], rows[:, 5] = mx, my, op
    rows[:, 2:5] = np.stack([a, b, c], 1)
    return rows


FOOTPRINT_CASES = ("random", "thin", "near_degenerate", "faint",
                   "opacity_one", "large", "edge", "not_pd", "tiny_opacity")


def _footprint_case(case, rng):
    """(means [n, 2], conics [n, 3], opacities [n]) float32 for the
    footprint tests, adversarial by name."""
    n = 40
    a = rng.uniform(0.005, 0.5, n)
    c = rng.uniform(0.005, 0.5, n)
    rho = rng.uniform(-0.95, 0.95, n)
    op = rng.uniform(0.05, 1.0, n)
    if case == "thin":                   # long thin ellipses, any direction
        a, c = rng.uniform(0.01, 2.0, n), rng.uniform(0.01, 2.0, n)
        rho = rng.choice([-1, 1], n) * (1 - 10.0 ** -rng.uniform(2, 4, n))
    elif case == "near_degenerate":      # b² ≈ ac, down to float rounding
        rho = rng.choice([-1, 1], n) * (1 - 10.0 ** -rng.uniform(4, 8, n))
        a, c = rng.uniform(0.5, 4.0, n), rng.uniform(0.5, 4.0, n)
    elif case == "faint":
        op = (1 / 255) * (1 + rng.choice([1e-6, 1e-5, 1e-4, 1e-2], n))
        a, c = rng.uniform(1e-3, 0.05, n), rng.uniform(1e-3, 0.05, n)
    elif case == "opacity_one":
        op = np.ones(n)
    elif case == "large":                # radii of hundreds of pixels
        a, c = rng.uniform(1e-4, 1e-3, n), rng.uniform(1e-4, 1e-3, n)
        op = rng.uniform(0.5, 1.0, n)
    elif case == "edge":
        a, c = rng.uniform(0.05, 1.0, n), rng.uniform(0.05, 1.0, n)
    elif case == "not_pd":
        rho = rng.choice([-1, 1], n) * rng.uniform(1.0, 1.3, n)
        a[::3] = -a[::3]
    elif case == "tiny_opacity":         # under 1/255 by a hair or more
        op = (1 / 255) * (1 - rng.choice([1e-7, 1e-5, 0.5], n))
    b = rho * np.sqrt(np.abs(a * c))
    means = np.stack([rng.uniform(0, 1280, n), rng.uniform(0, 720, n)], 1)
    if case in ("edge", "faint"):        # some on pixel centres
        means[::2] = np.round(means[::2])
    if case == "edge":                   # a pixel on the exact alpha edge
        b[::2] = 0.0
        reach = np.sqrt(2 * np.log(255 * op[::2]) / a[::2])
        means[::2, 0] += reach.astype(np.float32)
    conics = np.stack([a, b, c], 1)
    return (means.astype(np.float32), conics.astype(np.float32),
            op.astype(np.float32))


@pytest.mark.parametrize("case", FOOTPRINT_CASES)
def test_alpha_footprint_is_conservative(case):
    """No pixel whose float32 plain-version alpha is >= 1/255 lies outside
    `alpha_footprint`'s box (compared as K2 compares it, in float32) or has
    a power under -tau; opacities under 1/255 get an empty box and blend
    nowhere, conics that are not positive definite no box; and where a
    bounded box exists it is within about a pixel of the exact extent."""
    rng = np.random.default_rng(FOOTPRINT_CASES.index(case) + 20)
    means, conics, ops = _footprint_case(case, rng)
    rx, ry, tau = alpha_footprint(torch.from_numpy(conics),
                                  torch.from_numpy(ops))
    for k in range(len(ops)):
        mx, my = (torch.tensor(v) for v in means[k])
        a, b, c = (torch.tensor(v) for v in conics[k])
        op = torch.tensor(ops[k])
        reach = 40 if not torch.isfinite(rx[k]) else min(
            int(max(rx[k], ry[k])) + 6, 400)
        px = torch.arange(int(mx) - reach, int(mx) + reach + 1,
                          dtype=torch.float32)
        py = torch.arange(int(my) - reach, int(my) + reach + 1,
                          dtype=torch.float32)[:, None]
        dx, dy = mx - px, my - py
        power = gaussian_power(dx, dy, a, b, c)
        alpha = alpha_from_power(power, op)
        blends = alpha > 0
        if ops[k] < ALPHA_EPS:
            assert float(rx[k]) == float(ry[k]) == -np.inf
            assert not blends.any()
            continue
        det = float(a) * float(c) - float(b) ** 2
        if det <= 0 or float(a) <= 0:
            assert float(rx[k]) == float(ry[k]) == np.inf
        inside = (~(mx + rx[k] < px) & ~(mx - rx[k] > px)
                  & ~(my + ry[k] < py) & ~(my - ry[k] > py))
        assert not (blends & ~inside).any(), k
        assert not (blends & (power < -tau[k])).any(), k
        ln = np.log(255 * float(op))
        ac = float(a) * float(c)
        if torch.isfinite(rx[k]) and ln > 0.1 and det > 1e-3 * ac:
            # the exact half-extents, widened by the slack on det and tau
            exact = np.sqrt(2 * ln / det * np.float64([c, a]))
            slack = np.sqrt(det / (det - 2e-5 * ac) * (1 + 2e-3 / ln))
            assert float(rx[k]) <= exact[0] * slack + 1.01
            assert float(ry[k]) <= exact[1] * slack + 1.01
    if case == "random":
        assert torch.isfinite(rx).all() and (rx > 1).all()


def test_warp_touched_counts_match_a_per_warp_loop():
    """`bwd_warp_touched` (and the other backward counts) equal those of a
    per-warp loop over the lists on splats that probe the cull, with
    ragged edge tiles, and the cull keeps every warp that blends."""
    rng = np.random.default_rng(8)
    w, h = 45, 30
    rows = np.concatenate([_cull_rows(rng, case, 30, w, h)
                           for case in ("edge", "faint", "not_pd")])
    n = len(rows)
    tiles = np.sort(rng.integers(0, 6, 3 * n))
    ids = rng.integers(0, n, tiles.size).astype(np.int32)
    bounds = np.searchsorted(tiles, np.arange(7)).astype(np.int32)
    got = tref.blend_tiles_reference(
        *(torch.from_numpy(x) for x in (rows, ids, bounds)), w, h, 3,
        count_pairs=True)[3]
    want, _ = _walk_counts(rows, ids, bounds, w, h, 3)
    assert got == want
    assert (got["bwd_warp_blended"] <= got["bwd_warp_touched"]
            < got["bwd_evaluated"] // 32)


def test_fwd_warp_counts_match_a_per_warp_loop():
    """`fwd_warp_touched` and `fwd_warp_exp` (and the other counts) equal
    those of a per-warp loop over the lists on splats that probe the cull,
    with ragged edge tiles; the warps walk fewer (warp, instance) pairs
    than the lists hold, and take the exp on no more of them."""
    rng = np.random.default_rng(18)
    w, h = 41, 27
    rows = np.concatenate([_cull_rows(rng, case, 30, w, h)
                           for case in ("edge", "faint", "not_pd")])
    n = len(rows)
    tiles = np.sort(rng.integers(0, 6, 3 * n))
    ids = rng.integers(0, n, tiles.size).astype(np.int32)
    bounds = np.searchsorted(tiles, np.arange(7)).astype(np.int32)
    got = tref.blend_tiles_reference(
        *(torch.from_numpy(x) for x in (rows, ids, bounds)), w, h, 3,
        count_pairs=True)[3]
    want, _ = _walk_counts(rows, ids, bounds, w, h, 3)
    assert got == want
    fw, fh = tref.FWD_WARP
    assert (0 < got["fwd_warp_exp"] <= got["fwd_warp_touched"]
            < got["evaluated"] // (fw * fh))


def test_fwd_warp_is_the_warp_of_the_kernel_source():
    """`reference.FWD_WARP`, the warp at which the plain version counts K1's
    pairs, is the warp of csrc/blend_forward.cu: kWarpW pixels wide and
    32 / kWarpW · kPerThread tall, a whole number of them to a tile."""
    text = tile_kernel.SOURCE.read_text()
    width, per_thread = (
        int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
        for name in ("kWarpW", "kPerThread"))
    assert tref.FWD_WARP == (width, 32 // width * per_thread)
    assert 16 % tref.FWD_WARP[0] == 0 and 16 % tref.FWD_WARP[1] == 0


def _k1_cull_keep(rows, ids, bounds, tiles_x):
    """What K1's cull keeps of each (tile, list position, pixel) pair, over
    lists padded to the longest, L: ([n_tiles, L, 256] bool, the instance's
    `alpha_footprint` box meets the warp of FWD_WARP pixels that holds the
    pixel; [n_tiles, L, 1] float32, -tau)."""
    fw, fh = tref.FWD_WARP
    rx, ry, tau = alpha_footprint(rows[:, 2:5], rows[:, 5])
    n_tiles = bounds.numel() - 1
    longest = int((bounds[1:] - bounds[:-1]).max())
    p = torch.arange(256)
    keep = torch.zeros((n_tiles, longest, 256), dtype=torch.bool)
    ntau = torch.zeros((n_tiles, longest, 1))
    for t in range(n_tiles):
        wx = ((t % tiles_x) * 16 + p % 16 // fw * fw).float()
        wy = ((t // tiles_x) * 16 + p // 16 // fh * fh).float()
        g = ids[bounds[t]:bounds[t + 1]].long()[:, None]
        mx, my = rows[g, 0], rows[g, 1]
        keep[t, :len(g)] = (~(mx + rx[g] < wx) & ~(mx - rx[g] > wx + fw - 1)
                            & ~(my + ry[g] < wy) & ~(my - ry[g] > wy + fh - 1))
        ntau[t, :len(g)] = -tau[g]
    return keep, ntau


def _cull_model_case(case):
    """(rows, ids, bounds, width, height) numpy: `_footprint_case`'s splats
    in a 45x30 image, every tile listing all of them in one random depth
    order. Each splat with a bounded alpha >= 1/255 region has the tip of
    that region furthest in x (even splats) or in y (odd ones) at a random
    point of the image, where the box is tight; the rest keep their place
    between pixel centres (positions modulo the image's size).
    `saturating`: one 16x16 tile of 200 opaque splats whose pixels reach
    T < 1e-4 and exclude the rest."""
    rng = np.random.default_rng(40 + (FOOTPRINT_CASES + ("saturating",))
                                .index(case))
    if case == "saturating":
        n, w, h = 200, 16, 16
        means = rng.uniform(0, 16, (n, 2))
        a, c = rng.uniform(0.01, 0.1, n), rng.uniform(0.01, 0.1, n)
        conics = np.stack([a, rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c), c], 1)
        ops = rng.uniform(0.6, 0.99, n)
    else:
        w, h = 45, 30
        means, conics, ops = _footprint_case(case, rng)
        n = len(ops)
        a, b, c = conics.astype(np.float64).T
        ln = np.log(255 * ops.astype(np.float64))
        det = a * c - b * b
        bounded = (det > 0) & (a > 0) & (ln > 0)
        with np.errstate(all="ignore"):
            rx, ry = np.sqrt(2 * ln * c / det), np.sqrt(2 * ln * a / det)
            to_tip = np.where((np.arange(n) % 2 == 0)[:, None],
                              np.stack([rx, -b * rx / c], 1),
                              np.stack([-b * ry / a, ry], 1))
        tips = np.stack([rng.uniform(2, w - 2, n), rng.uniform(2, h - 2, n)],
                        1)
        means = np.where(bounded[:, None],
                         tips + rng.choice([-1, 1], n)[:, None] * to_tip,
                         np.fmod(means, np.float32([w, h])))
    rows = np.zeros((n, 9), np.float32)
    rows[:, 0:2], rows[:, 2:5], rows[:, 5] = means, conics, ops
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    n_tiles = -(-w // 16) * -(-h // 16)
    ids = np.tile(rng.permutation(n), n_tiles).astype(np.int32)
    bounds = (n * np.arange(n_tiles + 1)).astype(np.int32)
    return rows, ids, bounds, w, h


@pytest.mark.parametrize("case", FOOTPRINT_CASES + ("saturating",))
def test_plain_model_of_k1_cull_is_bit_equal(case, monkeypatch):
    """A plain model of K1's cull — the plain version with the alpha of
    every pair outside its warp's box, or under -tau, set to 0 — gives
    rgb, final T and last_contrib bit-equal to the plain version's: the
    cull removes only pairs whose alpha is under 1/255."""
    rows, ids, bounds, w, h = (torch.from_numpy(x) if isinstance(
        x, np.ndarray) else x for x in _cull_model_case(case))
    tiles_x = -(-w // 16)
    want = tref.blend_tiles_reference(rows, ids, bounds, w, h, tiles_x)
    keep, ntau = _k1_cull_keep(rows, ids, bounds, tiles_x)
    culled = []
    plain_alpha = tref.alpha_from_power

    def k1_alpha(power, opacity):
        kept = keep & ~(power < ntau)
        culled.append(int((~kept).sum()))
        return torch.where(kept, plain_alpha(power, opacity), 0.0)

    monkeypatch.setattr(tref, "alpha_from_power", k1_alpha)
    got = tref.blend_tiles_reference(rows, ids, bounds, w, h, tiles_x)
    assert len(culled) == 1           # one tile group: the masks line up
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if case != "large":               # radii of hundreds of pixels
        assert culled[0] > 0
    if case == "saturating":
        assert float(want[1].min()) < 1e-3 and int(want[2].max()) < len(ids)


def _k4_lab_case():
    """A small lab table (`kvariants.lab_inputs`): tiles of 0-8 chunks of
    128 instances over a 64x32 view."""
    rows, ids, bounds = tkv.lab_inputs([1, 2, 8, 0, 3, 1, 1, 2], 8, seed=3,
                                       tiles_x=4, tiles_y=2, budget=2048,
                                       device="cpu")
    return rows, ids, bounds, 64, 32


@pytest.mark.parametrize("case", FOOTPRINT_CASES + ("saturating", "lab"))
def test_plain_model_of_k4_cull_is_bit_equal(case, monkeypatch):
    """A plain model of K4's cull — levels 2 and 3 of its plain version
    with the alpha of every pair outside its warp's box, or under -tau, set
    to 0 — gives level 2's sink (`_alpha_sums`, list order) and level 3's
    sink, T and last_contrib bit-equal to the unculled ones: the staged
    walk drops only pairs whose alpha is under 1/255 and meets the rest in
    list order, so its levels compute what they computed without the
    cull."""
    if case == "lab":
        rows, ids, bounds, w, h = _k4_lab_case()
    else:
        rows, ids, bounds, w, h = (torch.from_numpy(x) if isinstance(
            x, np.ndarray) else x for x in _cull_model_case(case))
    tiles_x, n_tiles = -(-w // 16), bounds.numel() - 1
    want = [tkv.blend_variant_reference(lv, rows, ids, bounds, w, h)
            for lv in (2, 3)]
    keep, ntau = _k1_cull_keep(rows, ids, bounds, tiles_x)
    # the same masks in list order, as _alpha_sums lays its pairs out
    pos, tile_of = tkv._list_positions(bounds, n_tiles)
    at = pos - bounds.to(torch.int64)[tile_of]
    culled = []

    def culled_alpha(kept_box, ntau_, plain):
        def alpha(power, opacity):
            kept = kept_box & ~(power < ntau_)
            culled.append(int((~kept).sum()))
            return torch.where(kept, plain(power, opacity), 0.0)
        return alpha

    monkeypatch.setattr(tkv, "alpha_from_power", culled_alpha(
        keep[tile_of, at], ntau[tile_of, at], tkv.alpha_from_power))
    monkeypatch.setattr(tref, "alpha_from_power", culled_alpha(
        keep, ntau, tref.alpha_from_power))
    got = [tkv.blend_variant_reference(lv, rows, ids, bounds, w, h)
           for lv in (2, 3)]
    assert len(culled) == 2           # one call a level: the masks line up
    for level, (g, x) in enumerate(zip(got, want), 2):
        for a, b in zip(g, x):
            assert torch.equal(a, b), level
    if case != "tiny_opacity":        # opacities under 1/255 blend nowhere
        assert float(want[0][0].max()) > 0 and float(want[1][0].max()) > 0
    if case != "large":               # radii of hundreds of pixels
        assert min(culled) > 0
    if case == "saturating":
        assert float(want[1][1].min()) < 1e-3


def test_blend_forward_rejects_bad_inputs():
    rows, ids, bounds = _chunk_boundary_rows()
    with pytest.raises(ValueError, match="unsupported device"):
        tile_kernel.blend_forward(torch.from_numpy(rows).to("meta"),
                                  torch.from_numpy(ids), torch.from_numpy(bounds),
                                  16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "chunk_boundary", "rasterize",
                                  "edge", "faint", "not_pd"])
def test_blend_forward_kernel_matches_plain_version(case):
    """K1 against its plain version on the same card inputs (2e-5);
    `edge`, `faint` and `not_pd` probe its footprint cull (`_cull_rows`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    if case in ("edge", "faint", "not_pd"):
        w, h = W, H
        rows, ids, bounds = (torch.from_numpy(x).to(dev)
                             for x in _cull_lists(rng, case))
    elif case == "random":
        w, h = W, H
        rows, ids, bounds = (torch.from_numpy(x).to(dev)
                             for x in _random_rows(rng, TILES_X, 2, 300))
    elif case == "chunk_boundary":
        w, h = 16, 16
        rows, ids, bounds = (torch.from_numpy(x).to(dev)
                             for x in _chunk_boundary_rows())
    else:
        w, h = 45, 30                           # ragged edge tiles
        cam = make_camera(0, np.eye(3), np.zeros(3), 1.0, 0.8, w, h)
        n = 400
        means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                          rng.uniform(1.5, 5.0, n)], 1).astype(np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
        opac = torch.from_numpy(rng.uniform(0.3, 1, n).astype(np.float32))
        colors = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
        proj = trz.project_gaussians(
            torch.from_numpy(means).to(dev),
            torch.from_numpy(rng.uniform(0.02, 0.12, (n, 3)).astype(
                np.float32)).to(dev),
            torch.from_numpy(quats).to(dev),
            torch.from_numpy(cam.world_view).to(dev),
            torch.from_numpy(cam.full_proj).to(dev), cam.tanfovx,
            cam.tanfovy, w, h, opacities=opac.to(dev))
        inst = trz.expand_and_sort(proj, (w + 15) // 16, (h + 15) // 16)
        rows = trz.splat_rows(proj, colors.to(dev), opac.to(dev))
        ids, bounds = inst.gauss_ids, inst.tile_bounds
    before = tile_kernel.launches
    got = tile_kernel.blend_forward(rows, ids, bounds, w, h)
    torch.cuda.synchronize()
    assert tile_kernel.launches == before + 1
    want = tref.blend_tiles_reference(rows, ids, bounds, w, h, (w + 15) // 16)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=2e-5)
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())
    if case == "chunk_boundary":
        assert float(got[0][1].abs().max()) == 0.0


def _cotangents(rng, width, height):
    d_rgb = rng.normal(size=(3, height, width)).astype(np.float32)
    d_ft = rng.normal(size=(height, width)).astype(np.float32)
    return torch.from_numpy(d_rgb), torch.from_numpy(d_ft)


def _autograd_rows(rows, ids, bounds, width, height, d_rgb, d_ft,
                   t_eps=1e-4):
    """dL/d rows by autograd through the whole plain forward at once."""
    r = rows.detach().clone().requires_grad_(True)
    rgb, ft, _ = tref.blend_tiles_reference(r, ids, bounds, width, height,
                                            (width + 15) // 16, t_eps=t_eps)
    loss = (rgb * d_rgb).sum() + (ft * d_ft).sum()
    return torch.autograd.grad(loss, r)[0]


@pytest.mark.parametrize("max_elems", [256 * 300, 1 << 26])
def test_blend_backward_cpu_takes_plain_version(max_elems):
    """On CPU tensors K2's wrapper runs the plain version (autograd through
    the plain blend, group by group) and launches nothing."""
    rng = np.random.default_rng(4)
    rows, ids, bounds = (torch.from_numpy(x)
                         for x in _random_rows(rng, TILES_X, 2, 200))
    d_rgb, d_ft = _cotangents(rng, W, H)
    rgb, ft, last = tile_kernel.blend_forward(rows, ids, bounds, W, H)
    before = tile_kernel.backward_launches
    got = tile_kernel.blend_backward(rows, ids, bounds, rgb, ft, last, d_rgb,
                                     d_ft, W, H)
    assert tile_kernel.backward_launches == before
    grouped = tref.blend_tiles_backward_reference(
        rows, ids, bounds, rgb, ft, last, d_rgb, d_ft, W, H,
        max_elems=max_elems)
    want = _autograd_rows(rows, ids, bounds, W, H, d_rgb, d_ft)
    assert got.shape == rows.shape and float(want.abs().max()) > 0
    for g in (got, grouped):     # groups may sum in another order
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_blend_backward_rejects_bad_inputs():
    rows, ids, bounds = (torch.from_numpy(x) for x in _chunk_boundary_rows())
    rgb, ft, last = tile_kernel.blend_forward(rows, ids, bounds, 16, 16)
    d_rgb, d_ft = torch.zeros_like(rgb), torch.zeros_like(ft)
    good = dict(rows=rows, gauss_ids=ids, tile_bounds=bounds, rgb=rgb,
                final_t=ft, last_contrib=last, d_rgb=d_rgb, d_final_t=d_ft,
                width=16, height=16)
    for change, match in (
            (dict(rows=rows.to("meta")), "unsupported device"),
            (dict(rows=rows.double()), "rows must be a contiguous"),
            (dict(rows=rows[:, :8]), r"rows must be \[G,9\]"),
            (dict(gauss_ids=ids.long()), "gauss_ids must be a contiguous"),
            (dict(tile_bounds=bounds[:1]), "tile_bounds"),
            (dict(last_contrib=last.float()), "last_contrib must be"),
            (dict(d_rgb=d_rgb.transpose(1, 2)), "d_rgb must be a contiguous"),
            (dict(d_final_t=d_ft[:8]), "d_final_t must have shape"),
            (dict(rgb=rgb[:2]), "rgb must have shape")):
        with pytest.raises(ValueError, match=match):
            tile_kernel.blend_backward(**dict(good, **change))


def _envelope_error(got, rows, ids, bounds, width, height, d_rgb, d_ft,
                    delta=2e-4):
    """Largest distance of `got` outside the envelope of the plain gradients
    at t_eps·(1-δ), t_eps, t_eps·(1+δ), in units of each component's largest
    |grad| (a borderline include decision may flip between K1's sequential
    product and the plain version's log-space prefix)."""
    grads = [tref.blend_tiles_backward_reference(
        rows, ids, bounds, None, None, None, d_rgb, d_ft, width, height,
        t_eps=1e-4 * f) for f in (1 - delta, 1.0, 1 + delta)]
    g = torch.stack(grads)
    scale = g[1].abs().amax(0).clamp_min(1e-30)
    below = (g.amin(0) - got) / scale
    above = (got - g.amax(0)) / scale
    return float(torch.maximum(below, above).clamp_min(0).max())


def _cull_lists(rng, case, width=48, height=32, n=120):
    """`_cull_rows` splats in random (tile, depth) lists of a
    width x height image."""
    rows = _cull_rows(rng, case, n, width, height)
    n_tiles = -(-width // 16) * -(-height // 16)
    tiles = np.sort(rng.integers(0, n_tiles, 4 * n))
    ids = rng.integers(0, n, tiles.size).astype(np.int32)
    bounds = np.searchsorted(tiles, np.arange(n_tiles + 1)).astype(np.int32)
    return rows, ids, bounds


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "chunk_boundary", "rasterize",
                                  "edge", "faint", "not_pd"])
def test_blend_backward_kernel_matches_plain_version(case):
    """K2 against its plain version on the same card inputs: inside the
    envelope of the plain gradients at T_EPS·(1±2e-4), widened by 1.5e-3 of
    each component's largest |grad| (rounding between the kernel's
    sequential product and the plain version's log-space prefix). `edge`,
    `faint` and `not_pd` probe the footprint cull (`_cull_rows`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    if case in ("edge", "faint", "not_pd"):
        w, h = W, H
        rows, ids, bounds = (torch.from_numpy(x).to(dev)
                             for x in _cull_lists(rng, case))
    elif case == "random":
        w, h = W, H
        rows, ids, bounds = (torch.from_numpy(x).to(dev)
                             for x in _random_rows(rng, TILES_X, 2, 300))
    elif case == "chunk_boundary":
        w, h = 16, 16
        rows, ids, bounds = (torch.from_numpy(x).to(dev)
                             for x in _chunk_boundary_rows())
    else:
        w, h = 45, 30
        cam = make_camera(0, np.eye(3), np.zeros(3), 1.0, 0.8, w, h)
        n = 400
        means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                          rng.uniform(1.5, 5.0, n)], 1).astype(np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
        opac = torch.from_numpy(rng.uniform(0.3, 1, n).astype(np.float32))
        proj = trz.project_gaussians(
            torch.from_numpy(means).to(dev),
            torch.from_numpy(rng.uniform(0.02, 0.12, (n, 3)).astype(
                np.float32)).to(dev),
            torch.from_numpy(quats).to(dev),
            torch.from_numpy(cam.world_view).to(dev),
            torch.from_numpy(cam.full_proj).to(dev), cam.tanfovx,
            cam.tanfovy, w, h, opacities=opac.to(dev))
        inst = trz.expand_and_sort(proj, (w + 15) // 16, (h + 15) // 16)
        colors = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(
            np.float32)).to(dev)
        rows = trz.splat_rows(proj, colors, opac.to(dev))
        ids, bounds = inst.gauss_ids, inst.tile_bounds
    d_rgb, d_ft = (x.to(dev) for x in _cotangents(rng, w, h))
    rgb, ft, last = tile_kernel.blend_forward(rows, ids, bounds, w, h)
    before = tile_kernel.backward_launches
    got = tile_kernel.blend_backward(rows, ids, bounds, rgb, ft, last, d_rgb,
                                     d_ft, w, h)
    torch.cuda.synchronize()
    assert tile_kernel.backward_launches == before + 1
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0
    assert _envelope_error(got, rows, ids, bounds, w, h, d_rgb,
                           d_ft) <= 1.5e-3


K3_CASES = {                     # name: (shape, dtype, exclusive)
    "i32_wrap": ((2, 100_000), np.int32, False),
    "i32_rows_not_multiple_of_4": ((4, 10_001), np.int32, False),
    "f32_rows_not_multiple_of_4": ((4, 10_001), np.float32, True),
    "i32_misaligned_1d": ((20_000,), np.int32, False),
    "f32_misaligned_1d": ((20_000,), np.float32, False),
    "f32_16x1M": ((16, 1 << 20), np.float32, False),
    "i32_1d_exclusive": ((5000,), np.int32, True),
    "i32_one_row_1M": ((1, 1 << 20), np.int32, False),
    "i32_1M_exclusive": ((1, (1 << 20) + 3), np.int32, True),
    "u32": ((3, 10_000), np.uint32, False),
    "f32": ((8, 33_000), np.float32, False),
    "f32_one_row_exclusive": ((1, 300_001), np.float32, True),
    **{f"i32_{n}_{e}": ((8, n), np.int32, e == "exclusive")
       for n in (1, 127, 129, 4097, 8193)
       for e in ("inclusive", "exclusive")},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_lane_cumsum_kernel_matches_plain_version(case):
    """K3 against its plain version on the card: int32 and uint32 exact
    (two's complement wrap included), float32 within
    `scan.float_tolerance(N)` · Σ_{j≤i}|x_j| of a float64 prefix. Rows whose
    length is not a multiple of 4 and a 1-D view 4 bytes off a 16-byte
    boundary go through the kernel's scalar edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    shape, dtype, exclusive = K3_CASES[case]
    rng = np.random.default_rng(6)
    if dtype == np.float32:
        x = rng.normal(size=shape).astype(np.float32)
    elif dtype == np.uint32:
        x = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    else:
        x = rng.integers(-(2 ** 28), 2 ** 28, shape).astype(np.int32)
    xt = torch.from_numpy(x).cuda()
    if "misaligned" in case:
        xt = torch.cat([xt[:1], xt])[1:]
        assert xt.data_ptr() % 16 == 4 and xt.is_contiguous()
    before = tscan.launches
    got = tscan.lane_cumsum(xt, exclusive=exclusive)
    torch.cuda.synchronize()
    assert tscan.launches == before + 1
    assert got.dtype == xt.dtype and got.shape == xt.shape
    if dtype == np.float32:
        x64 = x.astype(np.float64)
        ref = np.cumsum(x64, axis=-1)
        mag = np.cumsum(np.abs(x64), axis=-1)
        if exclusive:
            ref = ref - x64
            mag = mag - np.abs(x64)
        err = np.abs(got.cpu().numpy() - ref)
        assert (err <= tscan.float_tolerance(shape[-1]) * mag + 1e-30).all()
    else:
        sign = got if dtype == np.int32 else got.view(torch.int32)
        want = tscan.lane_cumsum_reference(
            xt if dtype == np.int32 else xt.view(torch.int32), exclusive)
        np.testing.assert_array_equal(sign.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_lane_cumsum_leaves_its_scratch_zeroed():
    """K3's scratch is kept per stream and never zeroed by the wrapper: each
    launch leaves it zeroed for the next, through a shrink and a growth of
    the call's size, on the default stream and on another."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    rng = np.random.default_rng(9)
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for shape in ((3, 50_000), (1, 10), (40, 70_000), (2, 9000)):
                x = rng.integers(-1000, 1000, shape).astype(np.int32)
                got = tscan.lane_cumsum(torch.from_numpy(x).cuda())
                np.testing.assert_array_equal(
                    got.cpu().numpy(), np.cumsum(x, -1, dtype=np.int32))
        torch.cuda.synchronize()
        assert all(not bool(buf.any()) for buf in tscan._scratch.values())
    assert len(tscan._scratch) >= 2


K4_CASES = ("random", "chunk_boundary", "lab", "long_dense",
            "long_sparse") + FOOTPRINT_CASES + ("saturating",)


def _k4_case(case):
    """(rows, ids, bounds, width, height) on the CPU for the K4 card test:
    the golden cases, the small lab table, the footprint cases of the cull
    model, and lists of up to 10 chunks of 128 (five batches of 256, so
    that both staging buffers are refilled), dense enough to end pixels
    early (`long_dense`, 32x32) or spread over a 128x128 view."""
    if case == "random":
        return (*(torch.from_numpy(x) for x in _random_rows(
            np.random.default_rng(7), TILES_X, 2, 300)), W, H)
    if case == "chunk_boundary":
        return (*(torch.from_numpy(x) for x in _chunk_boundary_rows()), 16,
                16)
    if case == "lab":
        return _k4_lab_case()
    if case in ("long_dense", "long_sparse"):
        side = 2 if case == "long_dense" else 8
        cpt = [10, 5, 0, 3] + [0] * (side * side - 4)
        rows, ids, bounds = tkv.lab_inputs(cpt, len(cpt), seed=5,
                                           tiles_x=side, tiles_y=side,
                                           budget=2048, device="cpu")
        return rows, ids, bounds, 16 * side, 16 * side
    return tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                 for x in _cull_model_case(case))


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES)
@pytest.mark.parametrize("level", range(5))
def test_kvariant_kernel_matches_plain_version(level, case):
    """K4 at each level against its plain version on the card: v0 exact;
    the sinks of v1 and v2 1e-5 relative; v3's sink and v4 2e-5 absolute
    (v3's unscaled). v4 equals K1 bit for bit, and v3's T and last_contrib
    equal K1's, also where the staged walk culls (the footprint cases) and
    where a tile's list spans five batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    dev = torch.device("cuda")
    rows, ids, bounds, w, h = _k4_case(case)
    rows, ids, bounds = rows.to(dev), ids.to(dev), bounds.to(dev)
    before = list(tkv.launches)
    got = tkv.blend_variant(level, rows, ids, bounds, w, h)
    torch.cuda.synchronize()
    assert tkv.launches[level] == before[level] + 1
    want = tkv.blend_variant_reference(level, rows, ids, bounds, w, h)
    k1 = tile_kernel.blend_forward(rows, ids, bounds, w, h)
    got_np, want_np = (tuple(x.cpu().numpy() for x in o) for o in (got, want))
    if level <= 2:
        np.testing.assert_allclose(got_np[0], want_np[0], rtol=1e-5, atol=0)
        assert (got_np[1] == 1).all() and (got_np[2] == 0).all()
    else:
        scale = 1 / tkv.SINK if level == 3 else 1.0
        np.testing.assert_allclose(got_np[0] * scale, want_np[0] * scale,
                                   atol=2e-5)
        np.testing.assert_allclose(got_np[1], want_np[1], atol=2e-5)
        np.testing.assert_array_equal(got_np[2], want_np[2])
        assert torch.equal(got[1], k1[1]) and torch.equal(got[2], k1[2])
    if level == 4:
        assert torch.equal(got[0], k1[0])


def test_k4_long_cases_span_batches():
    """The long K4 card cases list more than two batches of 256 in a tile,
    so both staging buffers are refilled; the dense one ends pixels early
    (T under t_eps), the sparse one walks every batch."""
    for case in ("long_dense", "long_sparse"):
        rows, ids, bounds, w, h = _k4_case(case)
        assert int((bounds[1:] - bounds[:-1]).max()) > 2 * 256
        pairs = tref.blend_tiles_reference(rows, ids, bounds, w, h, w // 16,
                                           count_pairs=True)[3]
        assert (pairs["tested"] > pairs["blended"]) == (case == "long_dense")


TRANSPOSE_NC = [1, 7, 8, 9, 8394]      # 8394: the lab's [B/128, 128, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("nc", TRANSPOSE_NC)
@pytest.mark.parametrize("variant", sorted(txl.KERNELS))
def test_transpose_slab_kernel_matches_plain_version(variant, nc):
    """K5 and K6 against x.transpose(1, 2).contiguous() on the card, exact;
    nc not a multiple of K6's 8 slabs a block is masked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    x = torch.from_numpy(np.random.default_rng(nc).normal(
        size=(nc, txl.C, 16)).astype(np.float32)).cuda()
    before = dict(txl.launches)
    got = txl.transpose_slabs(x, variant)
    torch.cuda.synchronize()
    assert txl.launches[variant] == before[variant] + 1
    assert torch.equal(got, txl.transpose_slabs_reference(x))


def _card_model(n_pts=400):
    """A small seeded model on the card with non-trivial content (a few
    masks off), and its voxel size."""
    cfg = ModelConfig(feat_dim=8, n_offsets=4, level_num=3, voxel_size=0.05)
    rng = np.random.default_rng(3)
    model, voxel = tst.init_scene_model(
        rng.uniform(-1, 1, (n_pts, 3)), cfg,
        generator=torch.Generator().manual_seed(3), device="cuda")
    p = model.params

    def draw(x, s):
        return torch.from_numpy((rng.normal(size=tuple(x.shape)) * s).astype(
            np.float32)).cuda()

    p = p._replace(anchor_feat=draw(p.anchor_feat, 2.0),
                   hyper_latent=draw(p.hyper_latent, 2.0),
                   offsets=draw(p.offsets, 0.3),
                   mask_logit=torch.from_numpy(np.where(
                       rng.random(tuple(p.mask_logit.shape)) < 0.15, -8.0,
                       1.0).astype(np.float32)).cuda())
    return cfg, p, model.buffers, voxel


@pytest.mark.cuda
def test_codec_round_trip_on_card(tmp_path):
    """encode∘decode on the card reproduces the encoder's states exactly,
    and the decoded scene lies on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    cfg, p, b, voxel = _card_model()
    _, states = tcodec.encode_scene(p, b, cfg, [4.0, 16.0], voxel,
                                   str(tmp_path), return_states=True)
    dec = tcodec.decode_scene(str(tmp_path), cfg)
    for name in ("anchor", "feat", "scaling", "offsets", "masks", "hyper",
                 "level"):
        got = getattr(dec, name)
        assert got.is_cuda, name
        np.testing.assert_array_equal(got.cpu().numpy(), states[name],
                                      err_msg=name)


@pytest.mark.cuda
def test_codec_second_encode_identical_on_card(tmp_path):
    """A second encode of the same model on the card writes the same
    bytes, file for file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    cfg, p, b, voxel = _card_model()
    dirs = [str(tmp_path / name) for name in ("a", "b")]
    for d in dirs:
        tcodec.encode_scene(p, b, cfg, [4.0, 16.0], voxel, d)
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and "mlp.pkl" in names
    for name in names:
        with open(os.path.join(dirs[0], name), "rb") as fa, \
                open(os.path.join(dirs[1], name), "rb") as fb:
            assert fa.read() == fb.read(), name


# ---------------------------------------------------- the codec's CDF rows

CDF_SOURCE = tcdf.SOURCE


def _cdf_constants() -> dict:
    """The kernel's constants, read from its source: the Cephes arrays, the
    scalars and glibc exp's table."""
    src = CDF_SOURCE.read_text()
    out = {}
    for name, body in re.findall(
            r"__constant__ double (k[A-Z])\[\d+\] = \{([^}]*)\}", src):
        out[name] = [float(v) for v in body.replace("\n", " ").split(",")]
    for name, value in re.findall(
            r"constexpr double (k\w+) = ([-0-9.eE]+);", src):
        out[name] = float(value)
    body = re.search(r"kExpTab\[256\] = \{([^}]*)\}", src).group(1)
    out["tab"] = [int(v.strip().rstrip("ul"), 16)
                  for v in body.split(",") if v.strip()]
    return out


def _f64(bits: int) -> float:
    return float(np.array(bits & (2 ** 64 - 1), np.uint64).view(np.float64))


def _bits(x: float) -> int:
    return int(np.array(x, np.float64).view(np.uint64))


def _fma(a: float, b: float, c: float) -> float:
    """a·b + c rounded once (exact rationals, then Python's correctly
    rounded conversion)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _exp_model(x: float, c: dict) -> float:
    """The kernel's `exp_glibc`, operation for operation."""
    kd = c["kInvLn2N"] * x + c["kShift"]
    ki = _bits(kd)
    kd -= c["kShift"]
    r = _fma(kd, c["kNegLn2loN"], _fma(kd, c["kNegLn2hiN"], x))
    idx = 2 * (ki & 127)
    tail = _f64(c["tab"][idx])
    sbits = (c["tab"][idx + 1] + (ki << 45)) & (2 ** 64 - 1)
    r2 = r * r
    tmp = _fma(r2 * r2, _fma(r, c["kC5"], c["kC4"]),
               _fma(r2, _fma(r, c["kC3"], c["kC2"]), tail + r))
    if abs(x) < 512.0:
        scale = _f64(sbits)
        return _fma(scale, tmp, scale)
    scale = _f64(sbits + (1022 << 52))
    y = scale + scale * tmp
    if y < 1.0:
        lo = (scale - y) + scale * tmp
        hi = 1.0 + y
        lo = ((1.0 - hi) + y) + lo
        y = (hi + lo) - 1.0
    return c["kTwoM1022"] * y


def _polevl(x, coef, one=False):
    a = x + coef[0] if one else coef[0]
    for v in coef[1:]:
        a = a * x + v
    return a


def _ndtr_model(a: float, c: dict) -> float:
    """The kernel's `ndtr` (Cephes' ndtr, erf and erfc), operation for
    operation."""
    if a != a:
        return a
    x = a * c["kSqrtH"]
    z = abs(x)
    if z < 1.0:
        zz = x * x
        return 0.5 + 0.5 * (x * _polevl(zz, c["kT"])
                            / _polevl(zz, c["kU"], one=True))
    e2 = -(z * z)
    if e2 < -c["kMaxLog"]:
        y = 0.0
    else:
        p, q = ((_polevl(z, c["kP"]), _polevl(z, c["kQ"], one=True))
                if z < 8.0 else
                (_polevl(z, c["kR"]), _polevl(z, c["kS"], one=True)))
        y = 0.5 * ((_exp_model(e2, c) * p) / q)
    return 1.0 - y if x > 0.0 else y


def _cdf_rows_model(mean, scale, q, base, w, c):
    """The kernel's rows, row by row (its `cdf_entry`, quantization and
    per-row repair): (float64 rows, uint16 rows); raises where the kernel
    flags a row."""
    n = mean.shape[0]
    f = np.zeros((n, w + 1))
    u = np.zeros((n, w + 1), np.uint16)
    for i in range(n):
        s = np.float32(scale[i])
        sig = float(np.float32(1e-9) if s < np.float32(1e-9) else s)
        qd, mu, b = float(q[i]), float(mean[i]), float(base[i])
        qs = []
        for k in range(w + 1):
            if k in (0, w):
                v = float(k == w)
            else:
                z = ((b + (k - 0.5)) * qd - mu) / sig
                v = (float(z > 0.0) if w > 128 and not abs(z) < 6.0
                     else _ndtr_model(z, c))
                v = 0.0 if v < 0.0 else (1.0 if v > 1.0 else v)
            f[i, k] = v
            qs.append(-1 if v != v else int(np.rint(v * (65536.0 - w))) + k)
        qs = np.maximum.accumulate(np.array(qs))
        qs[0], qs[w] = 0, 65536
        for _ in range(2):
            if (np.diff(qs) >= 1).all():
                break
            qs[1:] = np.maximum(qs[1:], qs[:-1] + 1)
            qs[w] = 65536
            qs[:-1] = np.minimum(qs[:-1], 65536 - np.arange(w, 0, -1))
        if not (np.diff(qs) >= 1).all():
            raise ValueError("degenerate CDF row")
        u[i] = qs & 0xFFFF
    return f, u


def _host_cdf_rows(mean, scale, q, base, w):
    """The plain version on the host: (float64 rows, uint16 rows)."""
    with np.errstate(invalid="ignore"):
        f = tcodec._windowed_cdf_rows(mean, scale, q, base, w)
        return f, tcoder.quantize_cdf(f)


def test_plain_model_of_cdf_kernel_ndtr_is_bit_equal():
    """The kernel's exp and ndtr, run here from the constants in its source,
    give scipy's `ndtr` bit for bit over each branch: erf's, erfc's two
    polynomials, glibc exp's fast path and its special case below −512
    (normal and subnormal results), the underflow, ±∞, ±0 and NaN."""
    c = _cdf_constants()
    assert len(c["tab"]) == 256
    rng = np.random.default_rng(8)
    z = np.concatenate([
        rng.uniform(-1.45, 1.45, 1500),            # erf, and its edge
        rng.uniform(1.4, 11.4, 1500) * rng.choice([-1, 1], 1500),
        rng.uniform(11.3, 32.0, 800) * rng.choice([-1, 1], 800),
        -rng.uniform(32.0, 37.7, 800),              # exp's special case
        -rng.uniform(37.62, 37.68, 300),            # subnormal exp
        [0.0, -0.0, 1.0 / np.sqrt(2), -np.sqrt(2), 6.0, -6.0, 38.0, -38.0,
         -40.0, np.inf, -np.inf, np.nan]])
    got = np.array([_ndtr_model(float(v), c) for v in z])
    want = ndtr(z)
    same = (got.view(np.uint64) == want.view(np.uint64)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), (z[~same][:5], got[~same][:5], want[~same][:5])


def test_plain_model_of_cdf_kernel_rows_is_bit_equal():
    """The kernel's rows, modelled row by row here, equal the plain
    version's, float64 and uint16: narrow and wide windows, σ at and under
    the 1e-9 floor, σ far wider than the window, test_coder's σ = 1e-6 rows
    over −5..5, and NaN σ rows whose repair takes one pass (w = 2) and two
    (w = 3), mixed in one call with rows needing none; a NaN row at w = 4
    stays degenerate on both."""
    c = _cdf_constants()
    for w, (mean, scale, q, base) in _cdf_edge_cases(small=True):
        want = _host_cdf_rows(mean, scale, q, base, w)
        got = _cdf_rows_model(mean, scale, q, base, w, c)
        np.testing.assert_array_equal(got[1], want[1], err_msg=str(w))
        np.testing.assert_array_equal(got[0], want[0], err_msg=str(w))
    mean, scale, q, base = _nan_rows(4)
    with pytest.raises(ValueError, match="degenerate CDF row"):
        _host_cdf_rows(mean, scale, q, base, 4)
    with pytest.raises(ValueError, match="degenerate CDF row"):
        _cdf_rows_model(mean, scale, q, base, 4, c)


def _cdf_stream(kind, n):
    """(mean, scale, q) float32 of one flat stream of the codec's tests
    (`test_torch_codec.py::_stream`'s recipe)."""
    r = np.random.default_rng({"normal": 1, "outliers": 3, "wide": 4,
                               "int32_escapes": 5}[kind])
    q = (0.01 * (1 + r.random(n))).astype(np.float32)
    mean = (r.normal(0, 1, n) * 0.05).astype(np.float32)
    scale = (0.02 * (0.5 + r.random(n))).astype(np.float32)
    if kind == "wide":
        scale = np.full(n, 1.0, np.float32)
    elif kind == "int32_escapes":
        mean[::70] = -20000 * q[::70]
    return mean, scale, q


def _nan_rows(n):
    """Rows of one element each with σ NaN, over a window of 4 symbols."""
    return (np.zeros(n, np.float32), np.full(n, np.nan, np.float32),
            np.ones(n, np.float32), np.full(n, -2, np.int64))


def _cdf_edge_cases(small: bool) -> list:
    """[(w, (mean, scale, q, base))]: the rows the kernel must handle beyond
    the streams'."""
    rng = np.random.default_rng(12)
    floor = np.float32(1e-9)
    sigmas = np.array([floor, np.nextafter(floor, np.float32(0)), 5e-10, 0.0,
                       -1.0, 1e-40, np.nextafter(floor, np.float32(1)),
                       1e-6, 0.3, 50.0, 1e4], np.float32)
    cases = []
    for w in ((2, 3, 11, 64, 129) if small else
              (2, 3, 11, 64, 128, 129, 256, 2048)):
        n = sigmas.size * (2 if small else 40)
        q = rng.uniform(0.001, 2.0, n).astype(np.float32)
        mean = (rng.normal(0, 3, n) * q).astype(np.float32)
        scale = np.resize(sigmas, n) * np.where(
            np.resize(sigmas, n) > 1e-3, q, 1).astype(np.float32)
        base = tcodec._window_base(mean, q, w)
        if w in (2, 3):                 # NaN rows the repair mends
            nan = _nan_rows(3)
            mean, scale, q, base = (np.concatenate([a, b]) for a, b in
                                    zip((mean, scale, q, base),
                                        (nan[0], nan[1], nan[2],
                                         np.full(3, -1, np.int64))))
        cases.append((w, (mean, scale.astype(np.float32), q, base)))
    # test_coder.py's nearly degenerate rows: σ = 1e-6 over symbols −5..5
    n = 20 if small else 1000
    cases.append((11, (np.zeros(n, np.float32), np.full(n, 1e-6, np.float32),
                       np.ones(n, np.float32), np.full(n, -5, np.int64))))
    return cases


@pytest.mark.parametrize("w", [64, 256])
def test_cdf_probe_rows_take_every_branch_and_pass_on_this_host(w):
    """The rows `codec._check_card` holds the kernel to before its first
    build take each branch of its ndtr, at least 10 entries each: erf's,
    erfc's first polynomial, its second with glibc exp's fast path and with
    its special case (a² > 512), the underflow and, at w > 128, both sides
    of the cut at |z| = 6; and the kernel's arithmetic, modelled here, gives
    this host's plain rows on them bit for bit, so the check passes here."""
    mean, scale, q, base = tcodec._probe_rows(w)
    sig = np.maximum(scale, np.float32(1e-9)).astype(np.float64)
    edges = (base[:, None] + (np.arange(w + 1) - 0.5)[None, :]) * q[
        :, None].astype(np.float64)
    z = ((edges - mean[:, None]) / sig[:, None])[:, 1:-1]
    a = np.abs(z) * np.sqrt(0.5)
    if w > 128:
        assert (np.abs(z) >= 6).sum() >= 10
        a = a[np.abs(z) < 6]
    branches = dict(erf=a < 1, erfc_pq=(a >= 1) & (a < 8),
                    erfc_rs_fast=(a >= 8) & (a * a < 512),
                    erfc_rs_special=(a * a >= 512) & (a * a < 709.78),
                    underflow=a * a > 709.79)
    if w > 128:       # |z| < 6: erf's and erfc's first polynomial only
        branches = {k: branches[k] for k in ("erf", "erfc_pq")}
    counts = {k: int(v.sum()) for k, v in branches.items()}
    assert min(counts.values()) >= 10, counts
    want = _host_cdf_rows(mean, scale, q, base, w)
    got = _cdf_rows_model(mean, scale, q, base, w, _cdf_constants())
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int64),
                                  want[0].view(np.int64))


def test_cdf_rows_take_the_plain_version_on_the_cpu():
    """`_cdf_rows` on no device or the CPU is the plain version, float64
    rows only where asked, and launches nothing."""
    mean, scale, q = _cdf_stream("normal", 300)
    base = tcodec._window_base(mean, q, 64)
    want = _host_cdf_rows(mean, scale, q, base, 64)
    before = tcdf.launches
    for device in (None, torch.device("cpu"), "cpu"):
        f, u = tcodec._cdf_rows(mean, scale, q, base, 64, device)
        assert f is None
        np.testing.assert_array_equal(u, want[1])
        f, u = tcodec._cdf_rows(mean, scale, q, base, 64, device,
                                float_rows=True)
        np.testing.assert_array_equal(f, want[0])
        np.testing.assert_array_equal(u, want[1])
    assert tcdf.launches == before


def _assert_cdf_rows_equal(got, want, label):
    """uint16 rows equal; float64 rows within 4e-16 (NaN where NaN)."""
    np.testing.assert_array_equal(got[1], want[1], err_msg=label)
    assert got[0].shape == want[0].shape, label
    nan = np.isnan(want[0])
    np.testing.assert_array_equal(np.isnan(got[0]), nan, err_msg=label)
    assert np.abs(got[0][~nan] - want[0][~nan]).max() <= 4e-16, label


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "outliers", "wide",
                                  "int32_escapes"])
def test_cdf_rows_kernel_matches_plain_version(kind):
    """The kernel's rows against the plain version's on the card's host, for
    the codec tests' four streams at w = 64, 256 and 2048: 9.5M entries a
    stream, uint16 exact, float64 within 4e-16. One launch a call, once the
    host check has run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    dev = torch.device("cuda")
    tcodec._check_card(dev)      # its two launches, once a process
    mean, scale, q = _cdf_stream(kind, 4000)
    for w in (64, 256, 2048):
        base = tcodec._window_base(mean, q, w)
        before = tcdf.launches
        got = tcodec._cdf_rows(mean, scale, q, base, w, dev, float_rows=True)
        assert tcdf.launches == before + 1
        _assert_cdf_rows_equal(got, _host_cdf_rows(mean, scale, q, base, w),
                               f"{kind} w={w}")
        rows = tcodec._cdf_rows(mean, scale, q, base, w, dev)
        assert rows[0] is None
        np.testing.assert_array_equal(rows[1], got[1])


@pytest.mark.cuda
def test_cdf_rows_kernel_edge_rows():
    """σ at and under the 1e-9 floor, σ far wider than the window,
    test_coder's σ = 1e-6 rows over −5..5, NaN rows the repair mends in one
    pass and in two mixed with rows it leaves alone, and every width from
    2 to 2048 about the warp/block boundary; a NaN row at w = 64 is
    degenerate on both and raises the same error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    dev = torch.device("cuda")
    for w, (mean, scale, q, base) in _cdf_edge_cases(small=False):
        got = tcodec._cdf_rows(mean, scale, q, base, w, dev, float_rows=True)
        _assert_cdf_rows_equal(got, _host_cdf_rows(mean, scale, q, base, w),
                               f"w={w}")
    mean, scale, q, base = _nan_rows(5)
    for call in (lambda: _host_cdf_rows(mean, scale, q, base, 64),
                 lambda: tcodec._cdf_rows(mean, scale, q, base, 64, dev)):
        with pytest.raises(ValueError, match="degenerate CDF row"):
            call()


@pytest.mark.cuda
def test_cdf_rows_host_check_refuses_a_host_that_computes_otherwise(
        monkeypatch):
    """Where the host's plain rows differ from the kernel's in one float64
    bit of one probe entry, the card's first build raises, builds nothing
    for the codec, and raises again at the next call: no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    dev = torch.device("cuda")
    plain = tcodec._windowed_cdf_rows

    def other_host(*args):
        f = plain(*args)
        f.view(np.int64)[5, 7] += 1
        return f

    monkeypatch.setattr(tcodec, "_card_checked", False)
    monkeypatch.setattr(tcodec, "_windowed_cdf_rows", other_host)
    mean, scale, q = _cdf_stream("normal", 100)
    base = tcodec._window_base(mean, q, 64)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="differ from this host"):
            tcodec._cdf_rows(mean, scale, q, base, 64, dev)
    assert tcodec._card_checked is False
    monkeypatch.setattr(tcodec, "_windowed_cdf_rows", plain)
    got = tcodec._cdf_rows(mean, scale, q, base, 64, dev)
    assert tcodec._card_checked is True
    np.testing.assert_array_equal(got[1], _host_cdf_rows(mean, scale, q,
                                                         base, 64)[1])


@pytest.mark.cuda
def test_codec_card_encode_writes_the_plain_rows_bytes(tmp_path,
                                                      monkeypatch):
    """A card encode writes the same files, byte for byte, as the same
    encode with its rows built by the plain version on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    cfg, p, b, voxel = _card_model()
    card = str(tmp_path / "card")
    before = tcdf.launches
    tcodec.encode_scene(p, b, cfg, [4.0, 16.0], voxel, card)
    assert tcdf.launches > before
    plain = tcodec._cdf_rows
    monkeypatch.setattr(tcodec, "_cdf_rows",
                        lambda *a, **kw: plain(*a[:5], None,
                                               kw.get("float_rows", False)))
    host = str(tmp_path / "host")
    before = tcdf.launches
    tcodec.encode_scene(p, b, cfg, [4.0, 16.0], voxel, host)
    assert tcdf.launches == before
    names = sorted(os.listdir(card))
    assert names == sorted(os.listdir(host))
    for name in names:
        with open(os.path.join(card, name), "rb") as fa, \
                open(os.path.join(host, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.cuda
def test_codec_card_decode_launches_once_a_chunk(tmp_path, monkeypatch):
    """A card decode launches the kernel once for each `_cdf_rows` call,
    one a stream chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    cfg, p, b, voxel = _card_model()
    tcodec.encode_scene(p, b, cfg, [4.0, 16.0], voxel, str(tmp_path))
    calls = []
    real = tcodec._cdf_rows

    def counted(*args, **kw):
        calls.append(args[5] if len(args) > 5 else kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(tcodec, "_cdf_rows", counted)
    before = tcdf.launches
    tcodec.decode_scene(str(tmp_path), cfg)
    assert calls and all(torch.device(d).type == "cuda" for d in calls)
    assert tcdf.launches - before == len(calls)


# ---- the projection's kernels ----

# the scenes of the projection's card tests: every branch (48x32); a serve
# view's gaussians (1237x822, 1M) and anchors (200k, scales a column slice
# of [N,6] as the renderer's cull reads them); a training view's (980x545)
PROJ_SCENES = {
    "branch": lambda: projection_cases.branch_scene(),
    "serve": lambda: projection_cases.volume_scene(1_000_000, 1237, 822, 1),
    "train": lambda: projection_cases.volume_scene(400_000, 980, 545, 2),
    "anchors": lambda: projection_cases.volume_scene(
        200_000, 1237, 822, 3, scale_range=(0.001, 0.02)),
}
PROJ_BANDS = {"branch": (1, 3), "serve": (20, 17), "train": (10, 12),
              "anchors": None}


def _card_scene(case):
    """The scene's tensors on the card, the camera as the renderer holds it
    (the transposed arrays' strides kept)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    sc = PROJ_SCENES[case]()
    dev = torch.device("cuda")
    cam = sc["cam"]
    put = lambda x: torch.as_tensor(x, device=dev)
    return sc, dict(world_view=put(cam["world_view"]),
                    full_proj=put(cam["full_proj"]),
                    tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
                    width=sc["width"], height=sc["height"]), put


def _assert_same_projection(got, want, n):
    """Floats within 2e-6 relative (or equal, NaN included), integers
    equal."""
    for name in ("means2d", "conics", "depths"):
        a, b = getattr(got, name).cpu(), getattr(want, name).cpu()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        close = (a - b).abs() <= 2e-6 * b.abs()
        assert bool((same | close).all()), \
            f"{name}: {int((~(same | close)).sum())} of {n} off"
    for name in ("radii", "rect_min", "rect_max", "n_tiles"):
        a, b = getattr(got, name).cpu(), getattr(want, name).cpu()
        off = int((a != b).reshape(n, -1).any(1).sum())
        assert off == 0, f"{name}: {off} of {n} gaussians differ"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["opacities", "no_opacities", "band"])
@pytest.mark.parametrize("case", ["branch", "serve", "train"])
def test_projection_kernel_matches_plain_chain(case, variant):
    """The projection kernel against the plain chain on the same card
    inputs, in one launch."""
    sc, geom, put = _card_scene(case)
    n = len(sc["means"])
    args = (put(sc["means"]), put(sc["scales"]), put(sc["quats"]),
            geom["world_view"], geom["full_proj"], geom["tanfovx"],
            geom["tanfovy"], geom["width"], geom["height"])
    kw = dict(valid=put(sc["valid"]))
    if variant != "no_opacities":
        kw["opacities"] = put(sc["opac"])
    if variant == "band":
        kw["tile_band"] = PROJ_BANDS[case]
    before = tproj.launches
    got = trz.project_gaussians(*args, **kw)
    assert tproj.launches == before + 1
    want = tproj.project_gaussians_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int((want.radii > 0).sum()) > (10 if case == "branch" else n // 10)
    _assert_same_projection(got, want, n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["branch", "anchors"])
def test_cull_kernel_matches_plain_chain(case):
    """visible_filter's kernel (the projection's cull mode) against the
    plain chain, reading the scales as a column slice of [N,6]."""
    sc, geom, put = _card_scene(case)
    n = len(sc["means"])
    scaling = torch.cat([put(sc["scales"]), put(sc["scales"])], 1)
    args = (put(sc["means"]), scaling[:, :3], geom["world_view"],
            geom["full_proj"], geom["tanfovx"], geom["tanfovy"],
            geom["width"], geom["height"])
    for valid in (None, put(sc["valid"])):
        before = tproj.cull_launches
        got = trz.visible_filter(*args, valid=valid)
        assert tproj.cull_launches == before + 1
        want = tproj.visible_filter_plain(*args, valid=valid)
        torch.cuda.synchronize()
        assert 0 < int(want.sum()) < n
        assert int((got != want).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_depths", [False, True])
@pytest.mark.parametrize("case", ["branch", "train"])
def test_projection_backward_kernel_matches_autograd(case, with_depths):
    """The backward kernel against autograd of the plain chain and against
    reference.project_vjp_reference, with the cotangents as the rasterizer
    hands them over (column slices of one [G, 9] gradient)."""
    sc, geom, put = _card_scene(case)
    n = len(sc["means"])
    d_m, d_c, d_d = projection_cases.cotangents(n, 7)
    cot = put(np.concatenate([d_m, d_c, d_d[:, None], np.zeros((n, 3),
                                                              np.float32)],
                             1))
    if not with_depths:
        cot[:, 5] = 0.0

    def grads(project):
        leaves = [put(sc[k]).requires_grad_()
                  for k in ("means", "scales", "quats")]
        proj = project(*leaves, geom["world_view"], geom["full_proj"],
                       geom["tanfovx"], geom["tanfovy"], geom["width"],
                       geom["height"], valid=put(sc["valid"]),
                       opacities=put(sc["opac"]))
        parts = [proj.means2d, proj.conics]
        if with_depths:
            parts.append(proj.depths[:, None])
        rows = torch.cat(parts, 1)
        return torch.autograd.grad((rows * cot[:, :rows.shape[1]]).sum(),
                                   leaves)

    before = tproj.backward_launches
    got = grads(trz.project_gaussians)
    assert tproj.backward_launches == before + 1
    want = grads(tproj.project_gaussians_plain)
    ref = tref.project_vjp_reference(
        put(sc["means"]), put(sc["scales"]), put(sc["quats"]),
        geom["world_view"], geom["full_proj"], geom["tanfovx"],
        geom["tanfovy"], geom["width"], geom["height"], cot[:, :2],
        cot[:, 2:5], cot[:, 5] if with_depths else None)
    torch.cuda.synchronize()
    assert projection_cases.grad_errors(got, want) == []
    assert projection_cases.grad_errors(got, ref) == []


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["dtype", "device", "columns", "valid"])
def test_projection_kernel_wrapper_refuses_bad_inputs(fault):
    """On a CUDA tensor the wrappers raise on what the kernels do not read,
    and launch nothing."""
    sc, geom, put = _card_scene("branch")
    means, scales, quats = (put(sc[k]) for k in ("means", "scales", "quats"))
    cam = [geom["world_view"], geom["full_proj"], geom["tanfovx"],
           geom["tanfovy"], geom["width"], geom["height"]]
    valid = put(sc["valid"])
    if fault == "dtype":
        scales = scales.double()
    elif fault == "device":
        cam[0] = cam[0].cpu()
    elif fault == "columns":
        quats = torch.cat([quats, quats], 1)[:, ::2]
    else:
        valid = valid.to(torch.int32)
    counts = (tproj.launches, tproj.cull_launches)
    with pytest.raises(ValueError):
        trz.project_gaussians(means, scales, quats, *cam, valid=valid)
    if fault != "columns":
        with pytest.raises(ValueError):
            trz.visible_filter(means, scales, *cam, valid=valid)
    assert (tproj.launches, tproj.cull_launches) == counts


# ---- the tile binning's kernels ----

def _synthetic_projection(n, width, height, seed, sizes, culled=0.3,
                          band=None, depths=None):
    """The integer outputs of a projection (and its depths) as the binning
    reads them, drawn on the card: rects of `sizes(gen, n)` tiles across and
    down (clipped to the image or to `band`), their centres normal about the
    image's centre so the centre tiles run hot, a share `culled` with no
    tiles, depths uniform in [0.3, 50) unless given."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tiles_x, tiles_y = (width + 15) // 16, (height + 15) // 16
    lo, hi = (0, tiles_y) if band is None else (band[0],
                                                band[0] + band[1])
    w, h = sizes(gen, n)
    cx = (torch.randn(n, generator=gen, device=dev) * tiles_x / 5
          + tiles_x / 2)
    cy = torch.randn(n, generator=gen, device=dev) * tiles_y / 5 + tiles_y / 2
    x0 = (cx - w / 2).floor().to(torch.int32).clamp(0, tiles_x)
    y0 = (cy - h / 2).floor().to(torch.int32).clamp(lo, hi)
    x1 = (x0 + w).clamp(0, tiles_x)
    y1 = (y0 + h).clamp(lo, hi)
    n_tiles = (x1 - x0) * (y1 - y0)
    n_tiles[torch.rand(n, generator=gen, device=dev) < culled] = 0
    if depths is None:
        depths = torch.rand(n, generator=gen, device=dev) * 49.7 + 0.3
    zeros = torch.zeros(n, 2, device=dev)
    return tproj.ProjectedGaussians(
        means2d=zeros, conics=torch.zeros(n, 3, device=dev), depths=depths,
        radii=n_tiles.clone(), rect_min=torch.stack([x0, y0], 1),
        rect_max=torch.stack([x1, y1], 1), n_tiles=n_tiles.to(torch.int32))


def _rect_sizes(lo, hi):
    """Rect sides uniform in [lo, hi] tiles."""
    def draw(gen, n):
        return tuple(torch.randint(lo, hi + 1, (n,), generator=gen,
                                   device="cuda", dtype=torch.int32)
                     for _ in range(2))
    return draw


def _long_rect_sizes(gen, n):
    """Street level: sides log-uniform in [1, 22] tiles, tens of tiles a
    rect and some hundreds."""
    return tuple((2 ** (torch.rand(n, generator=gen, device="cuda") * 4.5))
                 .floor().to(torch.int32) for _ in range(2))


def _projected_view(case, band=None):
    """(ProjectedGaussians, tiles_x, tiles_y, row0) of a real projection of
    a projection test scene on the card."""
    sc, geom, put = _card_scene(case)
    kw = dict(valid=put(sc["valid"]), opacities=put(sc["opac"]))
    if band is not None:
        kw["tile_band"] = band
    proj = trz.project_gaussians(
        put(sc["means"]), put(sc["scales"]), put(sc["quats"]),
        geom["world_view"], geom["full_proj"], geom["tanfovx"],
        geom["tanfovy"], geom["width"], geom["height"], **kw)
    tiles_x = (geom["width"] + 15) // 16
    tiles_y = (geom["height"] + 15) // 16
    if band is None:
        return proj, tiles_x, tiles_y, 0
    return proj, tiles_x, band[1], band[0]


def _binning_case(case):
    """The binning's card cases: real projections (a mip360-serve-sized
    view, a training view, a band of it), the fly-in's top view (5.8M slots,
    ~2 tiles a kept slot, hot centre tiles) and street level (long
    rects), exact depth ties, no instances, and one gaussian over every
    tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    if case == "serve":
        return _projected_view("serve")
    if case == "train":
        return _projected_view("train")
    if case == "band":
        return _projected_view("serve", PROJ_BANDS["serve"])
    if case == "flyin_top":
        return (_synthetic_projection(5_800_000, 1920, 1080, 1,
                                      _rect_sizes(1, 2)), 120, 68, 0)
    if case == "street":
        return (_synthetic_projection(66_000, 1920, 1080, 2,
                                      _long_rect_sizes), 120, 68, 0)
    if case == "ties":
        depths = torch.randint(1, 4, (200_000,), device="cuda",
                               generator=torch.Generator("cuda").manual_seed(
                                   3)).float()
        return (_synthetic_projection(200_000, 1237, 822, 3,
                                      _rect_sizes(1, 4), depths=depths),
                78, 52, 0)
    if case == "band_synthetic":
        return (_synthetic_projection(300_000, 1920, 1080, 4,
                                      _rect_sizes(1, 6), band=(30, 17)),
                120, 17, 30)
    if case == "culled":
        return (_synthetic_projection(10_000, 1237, 822, 5, _rect_sizes(1, 3),
                                      culled=1.0), 78, 52, 0)
    if case == "empty":
        return (_synthetic_projection(0, 1237, 822, 6, _rect_sizes(1, 3)),
                78, 52, 0)
    assert case == "all_tiles"
    proj = _synthetic_projection(1000, 1920, 1080, 7, _rect_sizes(1, 3))
    proj.rect_min[17] = torch.tensor([0, 0], dtype=torch.int32)
    proj.rect_max[17] = torch.tensor([120, 68], dtype=torch.int32)
    proj.n_tiles[17] = 120 * 68
    return proj, 120, 68, 0


BINNING_CASES = ("serve", "train", "band", "flyin_top", "street", "ties",
                 "band_synthetic", "culled", "empty", "all_tiles")


@pytest.mark.cuda
@pytest.mark.parametrize("case", BINNING_CASES)
def test_binning_kernels_match_plain_chain(case):
    """expand_and_sort's two passes against expand_and_sort_plain on the
    same card inputs: gauss_ids, tile_bounds, demand and n_vis equal; two
    launches a call; the counters tile_instances and bin_card_instances
    both the demand, and one read-back."""
    proj, tiles_x, tiles_y, row0 = _binning_case(case)
    before = tsort.launches
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        got = trz.expand_and_sort(proj, tiles_x, tiles_y, row0)
    counts = {}
    for c in trace.take().counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    assert tsort.launches == before + 2
    want = tsort.expand_and_sort_plain(proj, tiles_x, tiles_y, row0)
    torch.cuda.synchronize()
    assert tsort.launches == before + 2
    assert counts == {"tile_instances": want.demand,
                      "bin_card_instances": want.demand, "syncs": 1}
    assert got.demand == want.demand
    assert got.n_vis.dtype == want.n_vis.dtype == torch.int64
    assert int(got.n_vis) == int(want.n_vis)
    assert got.gauss_ids.dtype == got.tile_bounds.dtype == torch.int32
    assert torch.equal(got.tile_bounds, want.tile_bounds)
    assert torch.equal(got.gauss_ids, want.gauss_ids)
    n = proj.depths.shape[0]
    if case == "flyin_top":
        assert n > 5_000_000 and want.demand > 7_000_000
    elif case == "street":
        assert want.demand > 10 * int(want.n_vis)
        assert int(proj.n_tiles.max()) > 200
    elif case in ("culled", "empty"):
        assert want.demand == 0 and not bool(got.tile_bounds.any())
    elif case == "all_tiles":
        assert bool((got.tile_bounds[1:] > got.tile_bounds[:-1]).all())
    elif case == "ties":
        assert int(torch.unique(proj.depths).numel()) == 3
    else:
        assert want.demand > int(want.n_vis) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["dtype", "device", "columns"])
def test_binning_wrapper_refuses_bad_inputs(fault):
    """On CUDA tensors expand_and_sort raises on what its kernels do not
    read, and launches nothing."""
    proj, tiles_x, tiles_y, row0 = _binning_case("culled")
    if fault == "dtype":
        proj = proj._replace(rect_min=proj.rect_min.long())
    elif fault == "device":
        proj = proj._replace(n_tiles=proj.n_tiles.cpu())
    else:
        proj = proj._replace(rect_max=torch.cat(
            [proj.rect_max, proj.rect_max], 1)[:, ::2])
    before = tsort.launches
    with pytest.raises(ValueError):
        trz.expand_and_sort(proj, tiles_x, tiles_y, row0)
    assert tsort.launches == before


# ------------------------------------------------------------------ Adam

ADAM_STEP, ADAM_LR_SCALE = 1600, 3.7
ADAM_CASES = [("all", 1000), ("all", 400_000), ("plain", 1000),
              ("plain", 400_000), ("frozen", 1000), ("odd_misaligned", 1001),
              ("non_contiguous", 1000), ("grown", 1000)]


def _misaligned(x):
    """A contiguous copy of `x` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4
    return view


def _adam_card_inputs(case, capacity, gen):
    """`blank_params`' 46 leaves at the published widths on the card, filled
    from `gen` (a CUDA generator), the upper half of the anchor slots empty
    (zero, as the pool's dead slots are), and Adam's moments likewise."""
    params = tst.blank_params(ModelConfig(), capacity, device="cuda")
    leaves = tst.param_leaves(params)
    mu, nu = {}, {}
    for name, x in leaves.items():
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        mu[name] = torch.randn(x.shape, generator=gen, device="cuda") * 1e-2
        nu[name] = torch.rand(x.shape, generator=gen, device="cuda") * 1e-4
        if name in tst.ANCHOR_FIELDS:
            for t in (x, mu[name], nu[name]):
                t[capacity // 2:] = 0.0
    if case == "odd_misaligned":
        params = params._replace(anchor_feat=_misaligned(params.anchor_feat))
        mu["offsets"] = _misaligned(mu["offsets"])
        nu["scaling_log"] = _misaligned(nu["scaling_log"])
    return params, toptim.AdamState(mu=mu, nu=nu, count=7)


def _adam_card_grads(case, leaves, gen):
    """Gradients of the leaves a case gives one: "plain" those of a plain
    step (no prior, grid MLPs, hyper latent, rotation or opacity); "frozen"
    the lr-0 leaves alone; "non_contiguous" one MLP weight's a transposed
    view; the upper half of the anchor slots zero."""
    names = list(leaves)
    if case == "plain":
        names = [n for n in names
                 if n not in ("hyper_latent", "rotation", "opacity_raw")
                 and not n.startswith(("mlps.grid.", "prior."))]
    elif case == "frozen":
        names = ["anchor", "rotation", "opacity_raw"]
    grads = {}
    for name in names:
        x = leaves[name]
        g = torch.randn(x.shape, generator=gen, device="cuda") * 1e-2
        if name in tst.ANCHOR_FIELDS:
            g[x.shape[0] // 2:] = 0.0
        grads[name] = g
    if case == "non_contiguous":
        g = grads["mlps.opacity.l1.weight"]
        grads["mlps.opacity.l1.weight"] = g.t().contiguous().t()
        assert not grads["mlps.opacity.l1.weight"].is_contiguous()
    return grads


def _grow_reference(ref, capacity):
    """The reference's leaves padded as `loop.grow_capacity` pads the pool."""
    for name, xs in ref.items():
        if name in tst.ANCHOR_FIELDS:
            ref[name] = [torch.cat([x, x.new_zeros((capacity - x.shape[0],)
                                                   + x.shape[1:])])
                         for x in xs]


def _int_bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case,capacity", ADAM_CASES)
def test_adam_kernel_matches_the_op_chain(case, capacity):
    """Three consecutive `adam_update` calls, one launch each, against
    `chain_update` leaf by leaf on the same card: p, m and v bit-equal
    (lr-0 leaves and empty slots included). A non-contiguous gradient is
    read by the kernel too, in the same launch, and every element is counted
    in `adam_card_elems`; a pool grown between two calls is updated whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    gen = torch.Generator(device="cuda").manual_seed(capacity + len(case))
    params, state = _adam_card_inputs(case, capacity, gen)
    ref = {n: [x.clone(), state.mu[n].clone(), state.nu[n].clone()]
           for n, x in tst.param_leaves(params).items()}
    opt = OptimizationConfig()
    for call in range(3):
        if case == "grown" and call == 2:
            buffers = tst.Buffers(*(torch.zeros(capacity, device="cuda")
                                    for _ in tst.Buffers._fields))
            model, state = tloop.grow_capacity(
                tst.SceneModel(params, buffers), state, 4 * capacity)
            params = model.params
            _grow_reference(ref, 4 * capacity)
        leaves = tst.param_leaves(params)
        grads = _adam_card_grads(case, leaves, gen)
        it = ADAM_STEP + call
        before = toptim.launches
        trace.take()
        with profile(activities=[ProfilerActivity.CPU]):
            params, state = toptim.adam_update(params, grads, state, opt, it,
                                               ADAM_LR_SCALE)
        counts = {}
        for c in trace.take().counts:
            counts[c.name] = counts.get(c.name, 0) + c.n
        assert toptim.launches == before + 1
        total = sum(x.numel() for x in leaves.values())
        assert counts == {"adam_elems": total, "adam_card_elems": total}
        lrs = toptim.group_lrs(opt, it, ADAM_LR_SCALE)
        bc1, bc2 = toptim.bias_corrections(state.count, 0.9, 0.999)
        for name, (p, m, v) in ref.items():
            toptim.chain_update(p, grads.get(name), m, v,
                                toptim.leaf_lr(name, lrs), 0.9, 0.999, bc1,
                                bc2, 1e-15)
        torch.cuda.synchronize()
        for name, x in tst.param_leaves(params).items():
            for what, got, want in (("p", x, ref[name][0]),
                                    ("m", state.mu[name], ref[name][1]),
                                    ("v", state.nu[name], ref[name][2])):
                assert got.shape == want.shape, (name, what)
                diff = int((_int_bits(got) != _int_bits(want)).sum())
                assert diff == 0, f"call {call}: {name}.{what}: {diff} differ"


# ------------------------------------------------------- the segmented carry

CARRY_SIZES = (1, 2, carry_cases.TILE - 1, carry_cases.TILE,
               carry_cases.TILE + 1, 5 * carry_cases.TILE + 17, 3_000_000)
CARRY_CASES = ([(n, p) for n in CARRY_SIZES for p in carry_cases.PATTERNS]
               + [(12 * carry_cases.TILE + 5, "long_run"),
                  (3_000_000, "long_run"),
                  (5 * carry_cases.TILE + 17, "misaligned")])
CARRY_FAULTS = ("float_values", "int_flags", "lengths", "two_dims",
                "non_contiguous", "mixed_devices", "meta_device",
                "too_many_keys")


def _carry_inputs(n, pattern, dtype, device, seed=0):
    """(is_start, values) of a case on `device`; `misaligned` flags are a
    view 1 byte past their allocation's start, which takes the kernel's
    scalar edge."""
    rng = np.random.default_rng(seed)
    if pattern == "long_run":
        starts = carry_cases.long_run(n, rng)
    else:
        starts = carry_cases.starts(
            "half" if pattern == "misaligned" else pattern, n, rng)
    is_start = torch.from_numpy(starts).to(device)
    if pattern == "misaligned":
        is_start = torch.cat([is_start[:1], is_start])[1:]
        assert is_start.data_ptr() % 16 != 0 and is_start.is_contiguous()
    values = torch.from_numpy(carry_cases.values(n, dtype, rng)).to(device)
    return is_start, values


def _carry_fault(fault, device):
    """(is_start, values) that the carry refuses."""
    is_start, values = _carry_inputs(1000, "one_percent", np.int64, device)
    if fault == "float_values":
        return is_start, values.double()
    if fault == "int_flags":
        return is_start.to(torch.int32), values
    if fault == "lengths":
        return is_start, values[:-1]
    if fault == "two_dims":
        return is_start.reshape(10, 100), values.reshape(10, 100)
    if fault == "non_contiguous":
        return is_start, torch.stack([values, values], 1)[:, 0]
    if fault == "mixed_devices":
        return is_start, values.to("meta" if device.type == "cpu" else "cpu")
    if fault == "meta_device":
        return is_start.to("meta"), values.to("meta")
    n = tcarry.MAX_KEYS + 1             # views of one element: no memory
    return (is_start[:1].expand(n), values[:1].expand(n))


def _carry_counts(fn):
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counts = {}
    for c in trace.take().counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    return out, counts


@pytest.mark.parametrize("fault", CARRY_FAULTS)
def test_segmented_carry_refuses_what_the_kernel_does_not_take(fault):
    """Both paths take the same inputs: on CPU tensors `segmented_carry`
    raises on what the kernel would refuse, and launches nothing."""
    is_start, values = _carry_fault(fault, torch.device("cpu"))
    before = tcarry.launches
    with pytest.raises(ValueError):
        tlev.segmented_carry(is_start, values)
    assert tcarry.launches == before


def test_carry_kernel_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; the CPU path is the
    plain version's, chosen by `levels.segmented_carry`."""
    is_start, values = _carry_inputs(100, "half", np.int32, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcarry.segmented_carry(is_start, values)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_segmented_carry_counts_its_keys_on_the_cpu(dtype):
    """Under a recording profiler a CPU call adds its keys to `carry_keys`
    and none to `carry_card_keys`; it equals the plain version."""
    is_start, values = _carry_inputs(20_000, "one_percent", dtype, "cpu")
    got, counts = _carry_counts(lambda: tlev.segmented_carry(is_start,
                                                             values))
    assert counts == {"carry_keys": 20_000}
    assert torch.equal(got, tlev.segmented_carry_plain(is_start, values))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n,pattern", CARRY_CASES)
def test_carry_kernel_matches_plain_version(n, pattern, dtype):
    """`levels.segmented_carry` on CUDA tensors launches the kernel once and
    is bit-equal to `segmented_carry_plain` on the same card: sizes of 1, 2,
    a tile and one key either side of it, several tiles and 3M keys; every
    key a start, key 0 alone, key 0 not a start, 1% and half; start-free
    runs of 9 and 363 tiles; flags off a 16-byte boundary. Its keys are
    counted in `carry_keys` and `carry_card_keys`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    is_start, values = _carry_inputs(n, pattern, dtype, torch.device("cuda"),
                                     seed=n)
    before = tcarry.launches
    got, counts = _carry_counts(lambda: tlev.segmented_carry(is_start,
                                                             values))
    assert tcarry.launches == before + 1
    assert counts == {"carry_keys": n, "carry_card_keys": n}
    want = tlev.segmented_carry_plain(is_start, values)
    torch.cuda.synchronize()
    assert got.dtype == values.dtype and got.shape == values.shape
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_carry_kernel_leaves_its_scratch_zeroed():
    """The kernel's scratch is kept per stream and never zeroed by the
    wrapper: back-to-back calls of other sizes and both value types, on the
    default stream and on another, each find it zeroed and leave it so."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for k, (n, pattern, dtype) in enumerate((
                    (3_000_000, "one_percent", np.int64),
                    (10, "half", np.int32),
                    (12 * carry_cases.TILE + 5, "long_run", np.int32),
                    (1, "every", np.int64),
                    (200_003, "first_not_start", np.int64))):
                is_start, values = _carry_inputs(n, pattern, dtype,
                                                 torch.device("cuda"), k)
                got = tcarry.segmented_carry(is_start, values)
                assert torch.equal(
                    got, tlev.segmented_carry_plain(is_start, values))
        torch.cuda.synchronize()
        assert all(not bool(buf.any()) for buf in tcarry._scratch.values())
    assert len(tcarry._scratch) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ("float_values", "int_flags", "lengths",
                                   "non_contiguous", "mixed_devices"))
def test_carry_kernel_refuses_bad_inputs(fault):
    """On CUDA tensors the wrapper raises on what the kernel does not take
    (another value or flag type, mismatched lengths, a non-contiguous view,
    a CPU tensor beside a CUDA one) and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    is_start, values = _carry_fault(fault, torch.device("cuda"))
    before = tcarry.launches
    with pytest.raises(ValueError):
        tlev.segmented_carry(is_start, values)
    with pytest.raises(ValueError):
        tcarry.segmented_carry(is_start, values)
    assert tcarry.launches == before
