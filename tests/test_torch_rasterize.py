"""PyTorch port against the JAX reference: projection, tile binning, the plain
tile blend and `rasterize` forward, on the same numpy inputs (CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu.ops.rasterize import (expand_and_sort as jax_sort,
                                         project_gaussians as jax_project,
                                         rasterize as jax_rasterize,
                                         visible_filter as jax_visible)
from contextgs_tpu.ops.rasterize.common import T_EPS
from contextgs_tpu.ops.rasterize.reference import \
    blend_reference as jax_blend_reference
from contextgs_tpu_torch.ops import rasterize as trz
from contextgs_tpu_torch.ops.rasterize import reference as tref

from utils_synthetic import make_random_gaussians, make_test_camera

torch.set_num_threads(1)

W, H = 48, 32
TILES_X, TILES_Y = 3, 2
BUDGET = 2048


def _t(x):
    return torch.from_numpy(np.array(x))


def _cam_np(width, height):
    cam = make_test_camera(width=width, height=height)
    return dict(world_view=cam.world_view, full_proj=cam.full_proj,
                tanfovx=cam.tanfovx, tanfovy=cam.tanfovy)


@functools.lru_cache(maxsize=4)
def _jax_project_sort(width, height, with_opacity):
    cam = _cam_np(width, height)
    tx, ty = (width + 15) // 16, (height + 15) // 16

    @jax.jit
    def run(means, scales, quats, opac):
        proj = jax_project(means, scales, quats, cam["world_view"],
                           cam["full_proj"], cam["tanfovx"], cam["tanfovy"],
                           width, height,
                           opacities=opac if with_opacity else None)
        return proj, jax_sort(proj, tx, ty, BUDGET, 128)

    return run


@functools.lru_cache(maxsize=8)
def _jax_raster(width, height):
    cam = _cam_np(width, height)

    @jax.jit
    def run(means, scales, quats, colors, opac, bg):
        return jax_rasterize(means, scales, quats, colors, opac, width=width,
                             height=height, bg=bg, budget=BUDGET,
                             chunk_size=128, backend="reference", **cam)

    return run


def _torch_raster(width, height, scene, bg, **kw):
    cam = _cam_np(width, height)
    return trz.rasterize(*map(_t, scene), world_view=_t(cam["world_view"]),
                         full_proj=_t(cam["full_proj"]),
                         tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
                         width=width, height=height, bg=_t(bg), **kw)


def _proj_to_torch(proj):
    return trz.ProjectedGaussians(*(_t(x) for x in proj))


@pytest.mark.parametrize("with_opacity", [True, False])
def test_project_gaussians_matches_jax(rng, with_opacity):
    means, scales, quats, _, opac = make_random_gaussians(rng, 120)
    means[:3, 2] = [-1.0, 0.1, 0.25]        # behind, inside and past the cull
    proj_j, _ = _jax_project_sort(W, H, with_opacity)(means, scales, quats,
                                                      opac)
    cam = _cam_np(W, H)
    proj_t = trz.project_gaussians(
        _t(means), _t(scales), _t(quats), _t(cam["world_view"]),
        _t(cam["full_proj"]), cam["tanfovx"], cam["tanfovy"], W, H,
        opacities=_t(opac) if with_opacity else None)
    keep = np.asarray(proj_j.radii) > 0
    assert keep.sum() > 50 and (~keep).sum() >= 2
    for name in ("means2d", "conics", "depths"):
        np.testing.assert_allclose(getattr(proj_t, name).numpy()[keep],
                                   np.asarray(getattr(proj_j, name))[keep],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("radii", "rect_min", "rect_max", "n_tiles"):
        np.testing.assert_array_equal(getattr(proj_t, name).numpy(),
                                      np.asarray(getattr(proj_j, name)),
                                      err_msg=name)


def test_visible_filter_matches_jax(rng):
    means, scales, _, _, _ = make_random_gaussians(rng, 200, xy_extent=2.0,
                                                   z_range=(-1.0, 5.0))
    valid = rng.random(200) < 0.9
    cam = _cam_np(W, H)
    want = np.asarray(jax.jit(lambda m, s, v: jax_visible(
        m, s, cam["world_view"], cam["full_proj"], cam["tanfovx"],
        cam["tanfovy"], W, H, valid=v))(means, scales, valid))
    got = trz.visible_filter(_t(means), _t(scales), _t(cam["world_view"]),
                             _t(cam["full_proj"]), cam["tanfovx"],
                             cam["tanfovy"], W, H, valid=_t(valid)).numpy()
    assert 0 < want.sum() < 200
    np.testing.assert_array_equal(got, want)


def test_expand_and_sort_matches_jax_lists(rng):
    means, scales, quats, _, opac = make_random_gaussians(
        rng, 150, scale_range=(0.02, 0.3))
    means[7] = means[8]                          # an exact depth tie
    proj_j, inst_j = _jax_project_sort(W, H, True)(means, scales, quats, opac)
    assert not bool(inst_j.overflowed)
    inst_t = trz.expand_and_sort(_proj_to_torch(proj_j), TILES_X, TILES_Y)
    bj = np.asarray(inst_j.tile_bounds)
    gj, vj = np.asarray(inst_j.gauss_ids), np.asarray(inst_j.valid)
    bt, gt = inst_t.tile_bounds.numpy(), inst_t.gauss_ids.numpy()
    for t in range(TILES_X * TILES_Y):
        want = gj[bj[t]:bj[t + 1]][vj[bj[t]:bj[t + 1]]]
        np.testing.assert_array_equal(gt[bt[t]:bt[t + 1]], want,
                                      err_msg=f"tile {t}")
    assert inst_t.demand == int(inst_j.demand) == bt[-1] > 0
    assert int(inst_t.n_vis) == int(inst_j.n_vis)


@pytest.mark.parametrize("t_eps", [None, T_EPS * (1 - 2e-4), T_EPS * 30])
def test_blend_reference_matches_jax(rng, t_eps):
    means, scales, quats, colors, opac = make_random_gaussians(rng, 100)
    proj_j, inst_j = _jax_project_sort(W, H, True)(means, scales, quats, opac)
    kw = {} if t_eps is None else dict(t_eps=t_eps)
    img_j, ft_j = jax.jit(functools.partial(
        jax_blend_reference, width=W, height=H, **kw))(proj_j, inst_j,
                                                       colors, opac)
    proj_t = _proj_to_torch(proj_j)
    inst_t = trz.expand_and_sort(proj_t, TILES_X, TILES_Y)
    img_t, ft_t = tref.blend_reference(proj_t, inst_t, _t(colors), _t(opac),
                                       W, H, **kw)
    assert float(np.asarray(ft_j).min()) < 0.01      # early termination hit
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-6)
    np.testing.assert_allclose(ft_t.numpy(), np.asarray(ft_j), atol=1e-6)


def _chunk_boundary_scene():
    """The case where the Pallas forward resets T at a chunk boundary: three
    near-opaque splats finish the pixel, 253 faint ones follow, and the 257th
    is bright green. `blend_reference` (and the port) keep G = 0."""
    n = 257
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = 2.0 + 1e-3 * np.arange(n)
    scales = np.full((n, 3), 2.0, np.float32)
    quats = np.tile(np.float32([1, 0, 0, 0]), (n, 1))
    colors = np.tile(np.float32([1, 0, 0]), (n, 1))
    colors[-1] = [0.0, 1000.0, 0.0]
    opac = np.full(n, 0.05, np.float32)
    opac[:3] = [0.99, 0.98, 0.99]
    opac[-1] = 0.3
    return means, scales, quats, colors, opac


def _occluder_scene():
    """A fully opaque near splat hides a far one."""
    means = np.float32([[0.0, 0.0, 1.0], [0.0, 0.0, 3.0]])
    scales = np.full((2, 3), 0.5, np.float32)
    quats = np.float32([[1, 0, 0, 0], [1, 0, 0, 0]])
    colors = np.float32([[1.0, 0, 0], [0, 1.0, 0]])
    opac = np.float32([1.0, 1.0])
    return means, scales, quats, colors, opac


@pytest.mark.parametrize("case", ["random", "occluder", "chunk_boundary"])
def test_rasterize_forward_matches_jax(rng, case):
    if case == "random":
        w, h, bg = W, H, np.float32([0.1, 0.2, 0.3])
        scene = make_random_gaussians(rng, 80)
    elif case == "occluder":
        w, h, bg = 32, 32, np.zeros(3, np.float32)
        scene = _occluder_scene()
    else:
        w, h, bg = 16, 16, np.zeros(3, np.float32)
        scene = _chunk_boundary_scene()
    out_j = _jax_raster(w, h)(*scene, bg)
    out_t = _torch_raster(w, h, scene, bg)
    np.testing.assert_allclose(out_t.image.numpy(), np.asarray(out_j.image),
                               atol=2e-5)
    np.testing.assert_allclose(out_t.final_t.numpy(),
                               np.asarray(out_j.final_t), atol=2e-5)
    np.testing.assert_array_equal(out_t.radii.numpy(), np.asarray(out_j.radii))
    assert out_t.n_instances == int(out_j.n_instances)
    assert int(out_t.n_vis) == int(out_j.n_vis)
    assert out_t.overflowed is False and out_t.vis_overflowed is False
    img = out_t.image.numpy()
    if case == "occluder":
        assert img[0, 16, 16] > 0.9 and img[1, 16, 16] < 0.05
    elif case == "chunk_boundary":
        assert out_t.n_instances == 257
        assert img[1, 8, 8] == 0.0          # the green splat never blends
        assert img[0, 8, 8] > 0.9
    else:
        assert np.abs(img).sum() > 1.0 and out_t.final_t.min() < 0.999


def test_rasterize_screen_dummy_and_t_eps(rng):
    """A zero screen_dummy leaves the image unchanged; t_eps reaches the
    blend."""
    scene = make_random_gaussians(rng, 60)
    bg = np.zeros(3, np.float32)
    base = _torch_raster(W, H, scene, bg)
    dummy = _torch_raster(W, H, scene, bg,
                          screen_dummy=torch.zeros((60, 2)))
    np.testing.assert_array_equal(dummy.image.numpy(), base.image.numpy())
    loose = _torch_raster(W, H, scene, bg, t_eps=0.5)
    assert float(loose.final_t.min()) >= 0.5 - 1e-6
    assert float(base.final_t.min()) < 0.5
