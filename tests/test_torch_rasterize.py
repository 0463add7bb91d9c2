"""PyTorch port against the JAX reference: projection, tile binning, the plain
tile blend, `rasterize` forward and its gradients, on the same numpy inputs
(CPU)."""

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
from contextgs_tpu_torch.ops.rasterize import projection as tproj
from contextgs_tpu_torch.ops.rasterize import reference as tref
from contextgs_tpu_torch.ops.rasterize import sorting as tsort
from contextgs_tpu_torch.utils import trace

from projection_cases import BRANCH_ROWS, branch_scene, grad_errors
from projection_cases import cotangents as proj_cotangents
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


def test_expand_and_sort_cpu_runs_the_plain_chain(rng):
    """On CPU tensors expand_and_sort is the plain chain: no launch, the
    chain's outputs, its three read-backs, no card counter."""
    from torch.profiler import ProfilerActivity, profile

    means, scales, quats, _, opac = make_random_gaussians(
        rng, 150, scale_range=(0.02, 0.3))
    means[7] = means[8]                          # an exact depth tie
    proj_j, _ = _jax_project_sort(W, H, True)(means, scales, quats, opac)
    proj_t = _proj_to_torch(proj_j)
    before = tsort.launches
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        got = trz.expand_and_sort(proj_t, TILES_X, TILES_Y)
    counts = {}
    for c in trace.take().counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    want = tsort.expand_and_sort_plain(proj_t, TILES_X, TILES_Y)
    assert tsort.launches == before
    assert counts == {"tile_instances": want.demand, "syncs": 3}
    assert got.demand == want.demand > 0
    assert int(got.n_vis) == int(want.n_vis)
    assert torch.equal(got.gauss_ids, want.gauss_ids)
    assert torch.equal(got.tile_bounds, want.tile_bounds)


@pytest.mark.parametrize("n_tiles,bits", [
    (1, 1), (2, 1), (3, 2), (4056, 12), (8160, 13), (4080, 12),
    (1 << 12, 12), ((1 << 12) + 1, 13), (1 << 13, 13), ((1 << 13) + 1, 14),
    (1 << 20, 20), ((1 << 20) + 1, 21)])
def test_tile_sort_bits(n_tiles, bits):
    """The tile sort orders ceil(log2(n_tiles)) low bits (at least one):
    every id in [0, n_tiles) fits them, and n_tiles - 1 needs the top one."""
    assert tsort.tile_sort_bits(n_tiles) == bits
    assert n_tiles - 1 < 1 << bits
    if n_tiles > 1:
        assert (n_tiles - 1) >> (bits - 1) == 1


def _ranges_rule(keys, n_tiles):
    """The ranges kernel's rule (csrc/binning.cu, ranges_kernel) in plain
    PyTorch: boundary i in [0, B] writes i into every tile in
    (keys[i-1], keys[i]], from tile 0 for i = 0 and up to n_tiles for
    i = B."""
    b = keys.numel()
    bounds = torch.full((n_tiles + 1,), -1, dtype=torch.int32)
    for i in range(b + 1):
        lo = 0 if i == 0 else int(keys[i - 1]) + 1
        hi = n_tiles if i == b else min(int(keys[i]), n_tiles)
        bounds[lo:hi + 1] = i
    return bounds


@pytest.mark.parametrize("case", ["empty", "leading_empty", "trailing_empty",
                                  "both_ends_empty", "one_tile", "every_tile",
                                  "random"])
def test_tile_ranges_rule_matches_bincount(case):
    """The ranges rule gives the chain's tile_bounds (a zero, then the
    cumsum of bincount) on sorted tile ids, where tiles are empty at the
    start, at the end, everywhere or nowhere."""
    n_tiles = 24
    gen = torch.Generator().manual_seed(7)
    draw = {"empty": (0, 0, 0), "leading_empty": (5, 24, 60),
            "trailing_empty": (0, 17, 60), "both_ends_empty": (3, 20, 60),
            "one_tile": (9, 10, 7), "every_tile": (0, 24, 0),
            "random": (0, 24, 200)}[case]
    lo, hi, n = draw
    keys = torch.randint(lo, max(hi, lo + 1), (n,), generator=gen)
    if case == "every_tile":
        keys = torch.arange(n_tiles).repeat_interleave(
            torch.randint(1, 4, (n_tiles,), generator=gen))
    keys = torch.sort(keys).values
    want = torch.zeros(n_tiles + 1, dtype=torch.int32)
    want[1:] = torch.cumsum(torch.bincount(keys, minlength=n_tiles), 0)
    got = _ranges_rule(keys, n_tiles)
    assert torch.equal(got, want)
    if case in ("leading_empty", "both_ends_empty"):
        assert int(want[1]) == 0
    if case in ("trailing_empty", "both_ends_empty"):
        assert int(want[-2]) == keys.numel()


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


GRAD_ARGS = ("means", "scales", "quats", "colors", "opacities",
             "screen_dummy")


@functools.lru_cache(maxsize=8)
def _jax_raster_grad(width, height):
    cam = _cam_np(width, height)

    def loss(means, scales, quats, colors, opac, screen_dummy, bg, target):
        out = jax_rasterize(means, scales, quats, colors, opac, width=width,
                            height=height, bg=bg, budget=BUDGET,
                            chunk_size=128, backend="reference",
                            screen_dummy=screen_dummy, **cam)
        return jnp.mean(jnp.abs(out.image - target))

    return jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6))))


def _torch_raster_grad(width, height, scene, bg, target):
    args = [_t(x).requires_grad_(True) for x in scene]
    dummy = torch.zeros((args[0].shape[0], 2), requires_grad=True)
    cam = _cam_np(width, height)
    out = trz.rasterize(*args, world_view=_t(cam["world_view"]),
                        full_proj=_t(cam["full_proj"]),
                        tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
                        width=width, height=height, bg=_t(bg),
                        screen_dummy=dummy)
    loss = torch.abs(out.image - _t(target)).mean()
    return loss, torch.autograd.grad(loss, args + [dummy])


def _grad_case(rng, case):
    if case == "random":
        return W, H, make_random_gaussians(rng, 80)
    if case == "occluder":
        return 32, 32, _occluder_scene()
    return 16, 16, _chunk_boundary_scene()


@pytest.mark.parametrize("bg", ["zero", "nonzero"])
@pytest.mark.parametrize("case", ["random", "occluder", "chunk_boundary"])
def test_rasterize_gradients_match_jax(rng, case, bg):
    """Gradients of an L1 loss through `rasterize` (K1/K2's plain versions on
    the CPU) against jax.grad through the reference backend: 1e-5 of each
    argument's largest |grad|. A nonzero background makes the final
    transmittance reach the loss (the dL/dT_final term). Where an argument's
    gradient cancels by symmetry (the chunk-boundary splats are centred on
    the image: screen_dummy ≈ 1e-11, means ≈ 1e-4 from their depths), its
    scale is floored at 1e-3 of the largest gradient of any argument, so
    that the tolerance is not set by rounding noise."""
    w, h, scene = _grad_case(rng, case)
    bgv = (np.zeros(3, np.float32) if bg == "zero"
           else np.float32([0.3, 0.5, 0.7]))
    target = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    dummy = np.zeros((scene[0].shape[0], 2), np.float32)
    loss_j, grads_j = _jax_raster_grad(w, h)(*scene, dummy, bgv, target)
    loss_t, grads_t = _torch_raster_grad(w, h, scene, bgv, target)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-6)
    floor = 1e-3 * max(np.abs(np.asarray(g)).max() for g in grads_j)
    for name, got, want in zip(GRAD_ARGS, grads_t, grads_j):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert np.isfinite(got.numpy()).all(), name
        if case == "random" or name in ("colors", "opacities"):
            assert scale > 0, f"zero gradient for {name}"
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * max(scale, floor), rtol=0,
                                   err_msg=name)


def test_rasterize_color_gradient_vs_finite_differences(rng):
    """Colors enter the blend linearly and move no alpha or transmittance
    cut-off, so central differences are exact for them."""
    scene = list(make_random_gaussians(rng, 8))
    target = np.zeros((3, 32, 32), np.float32)
    bg = np.float32([0.2, 0.1, 0.0])
    _, grads = _torch_raster_grad(32, 32, scene, bg, target)
    g = grads[3].numpy()
    eps = 1e-2

    def loss(colors):
        with torch.no_grad():
            out = _torch_raster(32, 32, scene[:3] + [colors, scene[4]], bg)
        return float(torch.abs(out.image - _t(target)).mean())

    for i in range(4):
        c = scene[3].copy()
        c[i, 0] += eps
        lp = loss(c)
        c[i, 0] -= 2 * eps
        lm = loss(c)
        fd = (lp - lm) / (2 * eps)
        assert np.isclose(g[i, 0], fd, rtol=2e-2, atol=1e-3), \
            f"color[{i},0]: analytic {g[i, 0]} vs fd {fd}"
    assert np.abs(g).max() > 0


def _branch_leaves(sc):
    return [torch.from_numpy(sc[k]).requires_grad_()
            for k in ("means", "scales", "quats")]


def test_branch_scene_takes_every_branch():
    """The scene of the VJP tests: each row in BRANCH_ROWS takes its branch
    in the plain chain."""
    sc = branch_scene()
    cam = sc["cam"]
    e = tref._projection_terms(*map(torch.from_numpy, (
        sc["means"], sc["scales"], sc["quats"], cam["world_view"],
        cam["full_proj"])), cam["tanfovx"], cam["tanfovy"], sc["width"],
        sc["height"])
    rows = BRANCH_ROWS
    z, ux, uy = e["z"].numpy(), e["ux"].numpy(), e["uy"].numpy()
    lim_x, lim_y = np.float32(e["lim_x"]), np.float32(e["lim_y"])
    assert z[rows["behind"]] < 0 and 0 < z[rows["near"]] <= 0.2
    assert abs(z[rows["at_zero"]]) < 1e-6
    assert ux[3] > lim_x and ux[4] < -lim_x
    assert uy[5] > lim_y and uy[6] < -lim_y
    assert ux[7] == lim_x and ux[8] == -lim_x
    assert (e["det"].numpy()[list(rows["needles"])] <= 0).all()
    proj = tproj.project_gaussians_plain(
        *map(torch.from_numpy, (sc["means"], sc["scales"], sc["quats"],
                                cam["world_view"], cam["full_proj"])),
        cam["tanfovx"], cam["tanfovy"], sc["width"], sc["height"],
        valid=torch.from_numpy(sc["valid"]),
        opacities=torch.from_numpy(sc["opac"]))
    radii = proj.radii.numpy()
    for r in ("behind", "near", "at_zero", "needles", "faint"):
        assert (radii[np.r_[rows[r]]] == 0).all(), r
    assert (radii[~sc["valid"]] == 0).all()
    assert (radii > 0).sum() > 60


@pytest.mark.parametrize("with_opacity,tile_band,with_depths", [
    (False, None, True), (True, None, False), (False, (1, 1), False),
    (True, (0, 1), True)])
def test_project_vjp_reference_matches_autograd(with_opacity, tile_band,
                                                with_depths):
    """reference.project_vjp_reference against autograd of the plain chain
    on every branch of branch_scene: the gradient is the same whatever the
    opacities, valid and tile band (they only cull)."""
    sc = branch_scene()
    cam = sc["cam"]
    wv, fp = _t(cam["world_view"]), _t(cam["full_proj"])
    leaves = _branch_leaves(sc)
    proj = tproj.project_gaussians_plain(
        *leaves, wv, fp, cam["tanfovx"], cam["tanfovy"], sc["width"],
        sc["height"], valid=_t(sc["valid"]),
        opacities=_t(sc["opac"]) if with_opacity else None,
        tile_band=tile_band)
    d_m, d_c, d_d = map(lambda x: None if x is None else _t(x),
                        proj_cotangents(len(sc["means"]), 5, with_depths))
    loss = (proj.means2d * d_m).sum() + (proj.conics * d_c).sum()
    if with_depths:
        loss = loss + (proj.depths * d_d).sum()
    want = torch.autograd.grad(loss, leaves)
    got = tref.project_vjp_reference(
        *(x.detach() for x in leaves), wv, fp, cam["tanfovx"],
        cam["tanfovy"], sc["width"], sc["height"], d_m, d_c, d_d)
    assert grad_errors(got, want, row_tol=1e-4) == []


@pytest.mark.parametrize("scale_modifier", [1.0, 0.7])
def test_project_vjp_reference_takes_missing_cotangents(scale_modifier):
    """A cotangent autograd leaves out (None) contributes nothing, and the
    scale modifier scales the scales' gradient as in the plain chain."""
    sc = branch_scene(n=60, seed=3, scale_modifier=scale_modifier)
    cam = sc["cam"]
    wv, fp = _t(cam["world_view"]), _t(cam["full_proj"])
    d_m, d_c = map(_t, proj_cotangents(60, 9, False)[:2])
    for use in ("means2d", "conics"):
        leaves = _branch_leaves(sc)
        proj = tproj.project_gaussians_plain(
            *leaves, wv, fp, cam["tanfovx"], cam["tanfovy"], sc["width"],
            sc["height"], scale_modifier=scale_modifier)
        out, cot = ((proj.means2d, d_m) if use == "means2d"
                    else (proj.conics, d_c))
        want = torch.autograd.grad((out * cot).sum(), leaves,
                                   allow_unused=True)
        want = [torch.zeros_like(x) if w is None else w
                for x, w in zip(leaves, want)]
        got = tref.project_vjp_reference(
            *(x.detach() for x in leaves), wv, fp, cam["tanfovx"],
            cam["tanfovy"], sc["width"], sc["height"],
            d_m if use == "means2d" else None,
            d_c if use == "conics" else None, None,
            scale_modifier=scale_modifier)
        if use == "means2d":
            assert not got[1].any() and not got[2].any()
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                       rtol=1e-5, atol=0)
        else:
            assert grad_errors(got, want, row_tol=1e-4) == []


def test_projection_cpu_takes_plain_version():
    """On CPU tensors project_gaussians and visible_filter are the plain
    chain itself: no launch, the same outputs bit for bit."""
    sc = branch_scene(n=80, seed=4)
    cam = sc["cam"]
    args = (*map(_t, (sc["means"], sc["scales"], sc["quats"],
                      cam["world_view"], cam["full_proj"])), cam["tanfovx"],
            cam["tanfovy"], sc["width"], sc["height"])
    counts = (tproj.launches, tproj.cull_launches, tproj.backward_launches)
    kw = dict(valid=_t(sc["valid"]), opacities=_t(sc["opac"]),
              tile_band=(1, 1))
    got, want = (f(*args, **kw) for f in (trz.project_gaussians,
                                          tproj.project_gaussians_plain))
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
    cull = (args[0], args[1], *args[3:])
    assert torch.equal(trz.visible_filter(*cull, valid=_t(sc["valid"])),
                       tproj.visible_filter_plain(*cull,
                                                  valid=_t(sc["valid"])))
    assert (tproj.launches, tproj.cull_launches,
            tproj.backward_launches) == counts


@pytest.mark.parametrize("fault", ["dtype", "shape", "columns", "camera",
                                   "valid_dtype", "device", "camera_grad"])
def test_projection_kernel_args_refuse_bad_inputs(fault):
    """The kernels' argument check (run before every launch) raises on a
    dtype, shape, layout or device the kernels do not read."""
    sc = branch_scene(n=40, seed=6)
    cam = sc["cam"]
    args = dict(means3d=_t(sc["means"]), scales=_t(sc["scales"]),
                quats=_t(sc["quats"]), opacities=_t(sc["opac"]),
                valid=_t(sc["valid"]), world_view=_t(cam["world_view"]),
                full_proj=_t(cam["full_proj"]))
    tproj._forward_args(**args)
    if fault == "dtype":
        args["scales"] = args["scales"].double()
    elif fault == "shape":
        args["quats"] = args["quats"][:, :3]
    elif fault == "columns":
        args["means3d"] = torch.zeros(40, 6)[:, ::2]
    elif fault == "camera":
        args["world_view"] = args["world_view"][:3]
    elif fault == "valid_dtype":
        args["valid"] = args["valid"].to(torch.uint8)
    elif fault == "device":
        args["opacities"] = args["opacities"].to("meta")
    else:
        args["full_proj"] = args["full_proj"].requires_grad_()
    with pytest.raises(ValueError):
        tproj._forward_args(**args)
