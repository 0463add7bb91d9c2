"""The port's CUDA kernel K1 (tile-blend forward) against its plain version.

This file imports neither JAX nor the JAX package, so that it also runs on
the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Tests marked `cuda` skip without a card.
"""

import numpy as np
import pytest
import torch

from contextgs_tpu_torch.ops import rasterize as trz
from contextgs_tpu_torch.ops.rasterize import reference as tref
from contextgs_tpu_torch.ops.rasterize import tile_kernel
from contextgs_tpu_torch.scene.cameras import make_camera

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


def test_plain_version_pair_counts_match_a_walk():
    """The pair counts equal those of a per-pixel front-to-back walk, the
    loop K1 runs, and `last_contrib` is where each walk last blended."""
    rng = np.random.default_rng(3)
    rows, ids, bounds = _random_rows(rng, 2, 1, 40)
    w, h = 30, 12                                 # a ragged edge tile
    _, _, last, got = tref.blend_tiles_reference(
        *(torch.from_numpy(x) for x in (rows, ids, bounds)), w, h, 2,
        count_pairs=True)
    want = dict(evaluated=0, exp=0, tested=0, blended=0)
    r = rows.astype(np.float64)
    for y in range(h):
        for x in range(w):
            tile = (y // 16) * 2 + x // 16
            T, n_last = 1.0, 0
            for k in range(bounds[tile], bounds[tile + 1]):
                mx, my, a, b, cc, op = r[ids[k], :6]
                dx, dy = mx - x, my - y
                power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
                want["evaluated"] += 1
                if power > 0:
                    continue
                want["exp"] += 1
                alpha = min(0.99, op * np.exp(power))
                if alpha < 1 / 255:
                    continue
                want["tested"] += 1
                if T * (1 - alpha) < 1e-4:
                    break
                want["blended"] += 1
                T *= 1 - alpha
                n_last = k - bounds[tile] + 1
            assert last[y, x] == n_last
    assert got == want


def test_blend_forward_rejects_bad_inputs():
    rows, ids, bounds = _chunk_boundary_rows()
    with pytest.raises(ValueError, match="unsupported device"):
        tile_kernel.blend_forward(torch.from_numpy(rows).to("meta"),
                                  torch.from_numpy(ids), torch.from_numpy(bounds),
                                  16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "chunk_boundary", "rasterize"])
def test_blend_forward_kernel_matches_plain_version(case):
    """K1 against its plain version on the same card inputs (2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the GPU machine")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    if case == "random":
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
