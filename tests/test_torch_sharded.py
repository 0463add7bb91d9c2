"""Sharded training of the port (`parallel/`, `train/sharded_loop.py`) on
the CPU over gloo, against the JAX package's `parallel/sharded.py` on the
conftest's virtual CPU devices (reference backend) and against the port's
single-process step: the banded rasterize, the tree roots and the reshard,
one sharded step (plain, and context with the JAX package's per-shard draws
handed in), a sharded densify from a matched state, a run through a
densify, `drivers.train --mesh 2 --mesh_force_cpu`, and each loop resuming
the other's checkpoint.

The ranks are processes of their own (`comm.spawn`), each joined with a
timeout; their rendezvous is a file in a temporary directory, so
concurrent test workers never share a port."""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu import config as jcfg
from contextgs_tpu.models import state as jst
from contextgs_tpu.ops.rasterize import rasterize as jax_rasterize
from contextgs_tpu.parallel import sharded as jsh
from contextgs_tpu.train import optim as joptim
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.models import context as tctx
from contextgs_tpu_torch.models import densify as tdensify
from contextgs_tpu_torch.ops import rasterize as trz
from contextgs_tpu_torch.parallel import comm, sharded as tsh
from contextgs_tpu_torch.train import step as tstep
from contextgs_tpu_torch.train.sharded_loop import train_sharded

from utils_synthetic import make_random_gaussians, make_test_camera

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 32
RANKS = 4
TIMEOUT = 240           # seconds a spawn of ranks may take
MODEL_KW = dict(feat_dim=8, n_offsets=4, voxel_size=0.05,
                capacity_headroom=2.0)
ANCHOR_PARAMS = ("anchor_feat", "offsets", "mask_logit", "scaling_log",
                 "hyper_latent")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


# ------------------------------------------------------------ banded raster

BAND_W, BAND_H = 48, 40                      # 3 x 3 tiles
BANDS = {"inside": (1, 1), "straddling": (2, 2), "past": (3, 2)}


def _cam_np(width, height):
    cam = make_test_camera(width=width, height=height)
    return dict(world_view=cam.world_view, full_proj=cam.full_proj,
                tanfovx=cam.tanfovx, tanfovy=cam.tanfovy)


@functools.lru_cache(maxsize=4)
def _jax_band(band):
    cam = _cam_np(BAND_W, BAND_H)

    def loss(means, scales, quats, colors, opac, dummy, bg, cot):
        out = jax_rasterize(means, scales, quats, colors, opac, width=BAND_W,
                            height=BAND_H, bg=bg, budget=4096, chunk_size=128,
                            backend="reference", screen_dummy=dummy,
                            tile_band=band, **cam)
        return jnp.sum(out.image * cot), out

    return jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                      has_aux=True))


def _torch_band(scene, bg, cot, band):
    args = [_t(x).requires_grad_(True) for x in scene]
    dummy = torch.zeros((args[0].shape[0], 2), requires_grad=True)
    cam = _cam_np(BAND_W, BAND_H)
    out = trz.rasterize(*args, world_view=_t(cam["world_view"]),
                        full_proj=_t(cam["full_proj"]),
                        tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
                        width=BAND_W, height=BAND_H, bg=_t(bg),
                        screen_dummy=dummy, tile_band=band)
    loss = (out.image * _t(cot)).sum()
    return out, torch.autograd.grad(loss, args + [dummy])


@pytest.mark.parametrize("where", list(BANDS))
def test_banded_rasterize_matches_jax(rng, where):
    """A band inside the image, one that runs past its bottom and one
    wholly past it: image, final T, radii, and the gradients of a fixed
    cotangent within 1e-5 of each argument's largest |grad| (as the
    unbanded rasterize test holds them)."""
    band = BANDS[where]
    scene = make_random_gaussians(rng, 120, scale_range=(0.02, 0.2))
    bg = np.float32([0.1, 0.2, 0.3])
    cot = rng.normal(size=(3, band[1] * 16, BAND_W)).astype(np.float32)
    dummy = np.zeros((120, 2), np.float32)
    (_, out_j), grads_j = _jax_band(band)(*scene, dummy, bg, cot)
    out_t, grads_t = _torch_band(scene, bg, cot, band)
    assert tuple(out_t.image.shape) == (3, band[1] * 16, BAND_W)
    np.testing.assert_allclose(out_t.image.detach().numpy(),
                               np.asarray(out_j.image), atol=2e-5)
    np.testing.assert_allclose(out_t.final_t.detach().numpy(),
                               np.asarray(out_j.final_t), atol=2e-5)
    np.testing.assert_array_equal(out_t.radii.numpy(),
                                  np.asarray(out_j.radii))
    visible = int((out_t.radii > 0).sum())
    if where == "past":
        assert visible == 0
        np.testing.assert_array_equal(out_t.image.detach().numpy(),
                                      np.broadcast_to(bg[:, None, None],
                                                      out_t.image.shape))
    else:
        assert visible > 10
    for got, want in zip(grads_t, grads_j):
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   rtol=0)


@pytest.mark.parametrize("n_bands", [2, 3])
def test_stitched_bands_equal_the_whole_image(rng, n_bands):
    """The bands of the port, stitched, are the unbanded image bit for bit
    (the offset enters in integer tile rows, so every pixel blends the same
    float32 values); the gradients of the bands' losses, summed, are the
    unbanded gradient within 1e-6 of the largest (sums in another order).
    K2's plain version is held here; K2 itself on the card by
    chip_smoke.py's `sharded` phase."""
    scene = make_random_gaussians(rng, 150, scale_range=(0.02, 0.25))
    bg = np.float32([0.3, 0.5, 0.7])
    tiles_y = (BAND_H + 15) // 16
    rows = -(-tiles_y // n_bands)
    cot = rng.normal(size=(3, rows * n_bands * 16, BAND_W)).astype(
        np.float32)
    # a band renders whole tile rows: the pixel rows past the image carry
    # no cotangent, as the sharded loss masks them
    cot[:, BAND_H:] = 0.0
    whole, g_whole = _torch_band(scene, bg, cot[:, :BAND_H], None)
    parts = [_torch_band(scene, bg, cot[:, b * rows * 16:(b + 1) * rows * 16],
                         (b * rows, rows)) for b in range(n_bands)]
    image = torch.cat([p[0].image for p in parts], 1)[:, :BAND_H]
    final_t = torch.cat([p[0].final_t for p in parts], 0)[:BAND_H]
    assert torch.equal(image, whole.image)
    assert torch.equal(final_t, whole.final_t)
    visible = torch.stack([p[0].visibility for p in parts]).any(0)
    assert torch.equal(visible, whole.visibility)
    for i, g in enumerate(g_whole):
        summed = sum(p[1][i] for p in parts)
        scale = float(g.abs().max())
        assert scale > 0
        assert float((summed - g).abs().max()) <= 1e-6 * scale


# ---------------------------------------------------------- shared state

def _configs(**opt):
    base = dict(rate_sample_frac=1.0, **opt)
    jc = jcfg.TrainConfig(model=jcfg.ModelConfig(**MODEL_KW),
                          opt=jcfg.OptimizationConfig(**base),
                          pipe=jcfg.PipelineConfig(backend="reference",
                                                   chunk_size=128))
    tc = tcfg.TrainConfig(model=tcfg.ModelConfig(**MODEL_KW),
                          opt=tcfg.OptimizationConfig(**base))
    return jc, tc


def _jax_model(rng):
    """The JAX sharded test's model: 300 points in front of the camera,
    random features and offsets."""
    jc, _ = _configs()
    pts = rng.uniform(-0.7, 0.7, (300, 3)) + np.array([0, 0, 2.5])
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0), pts, jc.model)
    p = model.params._replace(
        anchor_feat=jax.random.normal(jax.random.PRNGKey(1),
                                      model.params.anchor_feat.shape) * 0.3,
        offsets=jax.random.normal(jax.random.PRNGKey(2),
                                  model.params.offsets.shape) * 0.1)
    return p, model.buffers, voxel


def _warm_adam(params, rng):
    """Adam moments as after some steps (count 10, second moments bounded
    away from 0): the first step of a fresh Adam moves every weight by
    ±lr whatever its gradient's size, so a gradient at rounding level
    decides a full 2·lr; with these moments a step is smooth in the
    gradient."""
    def mu(x):
        return jnp.asarray(rng.normal(size=np.shape(x)) * 1e-3, jnp.float32)

    def nu(x):
        return jnp.asarray(rng.uniform(1e-5, 1e-4, np.shape(x)), jnp.float32)

    return joptim.AdamState(mu=jax.tree.map(mu, params),
                            nu=jax.tree.map(nu, params),
                            count=jnp.asarray(10, jnp.int32))


def _port_state(params, buffers, adam, cfg_t):
    return (convert.params_from_numpy(_np_tree(params), cfg_t.model, "cpu"),
            convert.buffers_from_numpy(_np_tree(buffers), "cpu"),
            convert.adam_from_numpy(_np_tree(adam), cfg_t.model, "cpu"))


def _job(cfg_t, state, voxel, phase, actions, level_scales=(), gt=None,
         cam=None):
    params, buffers, adam = state
    return dict(cfg=cfg_t, params=params, buffers=buffers, adam=adam,
                width=W, height=H, phase=phase, level_scales=level_scales,
                voxel_size=voxel, spatial_lr_scale=1.0,
                cam=cam or make_test_camera(width=W, height=H)
                .as_device_dict(), gt=gt, bg=np.zeros(3, np.float32),
                actions=actions)


def _spawn(job, ranks=RANKS):
    return comm.spawn(tsh.run_steps, ranks, (job,), backend="gloo",
                      device_type="cpu", timeout=TIMEOUT)


def _full(results, index=-1):
    """The ranks' slabs after action `index`, concatenated by rank."""
    slabs = [r["slabs"][index] for r in results]
    return {k: torch.cat([s[k] for s in slabs]).numpy() for k in slabs[0]}


def _jax_leaves(tree, cfg_t):
    return {name: x.numpy() for name, x in tsh.st.param_leaves(
        convert.params_from_numpy(_np_tree(tree), cfg_t.model,
                                  "cpu")).items()}


def _check_step(results, p_j, b_j, cfg_t, with_stats):
    """The port's slabs against the JAX step's sharded arrays: the anchor
    parameters within 1e-4 and the MLP leaves under 2e-2 (the JAX sharded
    test's tolerances: Adam's first step is about lr·sign(g), so an MLP
    weight whose gradient is at rounding level may flip), and the
    replicated leaves equal on every rank."""
    got = _full(results)
    for name in ANCHOR_PARAMS:
        np.testing.assert_allclose(got[f"p.{name}"],
                                   np.asarray(getattr(p_j, name)), atol=1e-4,
                                   err_msg=name)
    want_net = _jax_leaves(p_j, cfg_t)
    for name, x in results[0]["net"].items():
        assert float(np.abs(x.numpy() - want_net[name]).max()) < 2e-2, name
        for r in results[1:]:
            assert torch.equal(r["net"][name], x), name
    if with_stats:
        for name in ("anchor_denom", "offset_denom"):
            np.testing.assert_array_equal(got[f"b.{name}"],
                                          np.asarray(getattr(b_j, name)),
                                          err_msg=name)
        for name in ("opacity_accum", "offset_grad_accum"):
            want = np.asarray(getattr(b_j, name))
            assert np.abs(want).max() > 0, name
            np.testing.assert_allclose(got[f"b.{name}"], want,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)


# ------------------------------------------------------ roots and reshard

def _reshard_inputs(rng):
    """A JAX state with dead slots, voxel duplicates grown into free slots
    and masks that drop a fifth of the anchors from the kept set."""
    p, b, voxel = _jax_model(rng)
    alive = np.asarray(b.alive).copy()
    anchor = np.asarray(p.anchor).copy()
    n_alive = int(alive.sum())
    dup = np.arange(n_alive, n_alive + 12)
    anchor[dup] = anchor[:12] + 1e-4                  # same voxels again
    alive[dup] = True
    alive[rng.choice(n_alive, 10, replace=False)] = False
    mask = np.where(rng.random((alive.size, 1)) < 0.2, -8.0, 2.0) \
        + rng.normal(size=(alive.size, 4))
    p = p._replace(anchor=jnp.asarray(anchor),
                   mask_logit=jnp.asarray(mask, jnp.float32))
    b = b._replace(alive=jnp.asarray(alive))
    adam = joptim.init_adam(p)
    adam = adam._replace(mu=adam.mu._replace(
        anchor_feat=jnp.asarray(rng.normal(size=p.anchor_feat.shape),
                                jnp.float32)))
    return p, b, adam, voxel


@pytest.mark.parametrize("case", ["spatial", "tree_roots", "min_capacity"])
def test_reshard_matches_jax(rng, case):
    """`reshard_anchors` array for array against the JAX package's: the
    spatial hash before the context phase, the tree-root hash after it, and
    the capacity grown to `min_capacity`; and `compute_tree_roots`."""
    _, cfg_t = _configs()
    p, b, adam, voxel = _reshard_inputs(rng)
    scales = (4.0, 16.0) if case == "tree_roots" else None
    min_cap = 4 * int(b.alive.shape[0]) if case == "min_capacity" else 0
    jp, jb, ja, jinfo = jsh.reshard_anchors(
        _np_tree(p), _np_tree(b), _np_tree(adam), RANKS, voxel,
        level_scales=scales, level_num=3, min_capacity=min_cap)
    tp, tb, ta, tinfo = tsh.reshard_anchors(
        *_port_state(p, b, adam, cfg_t), RANKS, voxel, level_scales=scales,
        level_num=3, min_capacity=min_cap)
    assert tinfo == jinfo
    assert jinfo["n_dupes_removed"] >= 12
    if case == "min_capacity":
        assert jinfo["capacity"] == min_cap
    for name in tsh.ANCHOR_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    for name in tb._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    for moments, tree in ((ta.mu, ja.mu), (ta.nu, ja.nu)):
        want = _jax_leaves(tree, cfg_t)
        for name in tsh.ANCHOR_FIELDS:
            np.testing.assert_array_equal(moments[name].numpy(), want[name],
                                          name)
    anchor = np.asarray(jst.get_anchor(p, b))
    kept = np.asarray(jst.get_mask_anchor(p, b.alive))
    np.testing.assert_array_equal(
        tsh.compute_tree_roots(anchor, kept, voxel, (4.0, 16.0), 3),
        jsh.compute_tree_roots(anchor, kept, voxel, (4.0, 16.0), 3))


# --------------------------------------------------------- the sharded step

def _jax_step(jc, phase, voxel, level_scales, p, b, adam, gt, it,
              with_stats, key):
    mesh = jsh.make_mesh(RANKS)
    sp, sb, sa, _ = jsh.shard_model(mesh, p, b, adam)
    step = jsh.make_sharded_train_step(
        jc, mesh, W, H, budget=8192, phase=phase, level_scales=level_scales,
        spatial_lr_scale=1.0, voxel_size=voxel, backend="reference")
    cam = {k: jnp.asarray(v) for k, v in
           make_test_camera(width=W, height=H).as_device_dict().items()}
    return step(sp, sb, sa, cam, jnp.asarray(gt), jnp.zeros(3),
                jnp.asarray(float(it)), jnp.asarray(with_stats), key)


def _draws_of(key, cfg_t, n_local):
    """The JAX sharded step's draws on each shard: the step key folded
    with the shard index, split into the context's and the rate's keys."""
    out = []
    for r in range(RANKS):
        kc, kr = jax.random.split(jax.random.fold_in(key, r))
        keys = jax.random.split(kc, cfg_t.model.level_num + 1)
        levels = [jax.random.split(keys[i], 3)
                  for i in range(cfg_t.model.level_num)]

        def u(k, shape):
            return _t(np.asarray(jax.random.uniform(k, shape, jnp.float32)))

        m = cfg_t.model
        out.append(tctx.ContextDraws(
            hyper=u(keys[-1], (n_local, m.hyper_dim)),
            feat=tuple(u(k[0], (n_local, m.feat_dim)) for k in levels),
            scaling=tuple(u(k[1], (n_local, 6)) for k in levels),
            offsets=tuple(u(k[2], (n_local, 3 * m.n_offsets))
                          for k in levels),
            rate=u(kr, (n_local,))))
    return out


@pytest.mark.parametrize("phase", ["plain", "context"])
def test_sharded_step_matches_jax(rng, phase):
    """One step on 4 port ranks against `make_sharded_train_step` on a
    4-device mesh, the same bands (one tile row each: two inside the
    32-pixel image, two wholly past it), the default λ_dssim = 0.2. The
    plain case accumulates the densify statistics too (the screen
    gradient rides the gather); the context case hands each rank the JAX
    package's per-shard draws. Its level scales are not integers: the
    anchors lie on the voxel grid, so at the JAX test's (4, 16) many
    position/scale ratios fall exactly on .5, where the last bit of the
    quantized anchor (which XLA's fused step rounds otherwise than op by
    op) decides the level key (ROADMAP queue 3)."""
    jc, cfg_t = _configs()
    p, b, voxel = _jax_model(rng)
    adam = _warm_adam(p, rng)
    gt = rng.random((3, H, W)).astype(np.float32)
    scales = (4.37, 15.73) if phase == "context" else ()
    with_stats = phase == "plain"
    key = jax.random.PRNGKey(3)
    p_j, b_j, _, m_j = _jax_step(jc, phase, voxel, scales, p, b, adam, gt,
                                 50, with_stats, key)
    n_local = p.anchor.shape[0] // RANKS
    draws = _draws_of(key, cfg_t, n_local) if phase == "context" else None
    results = _spawn(_job(
        cfg_t, _port_state(p, b, adam, cfg_t), voxel, phase,
        [dict(kind="step", it=50, with_stats=with_stats, draws=draws)],
        level_scales=scales, gt=gt))
    m = results[0]["metrics"][0]
    assert all(r["metrics"][0] == m for r in results)
    np.testing.assert_allclose(m["loss"], float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["l1"], float(m_j["l1"]), rtol=1e-5)
    if phase == "context":
        assert m["bit_per_param"] > 0
        np.testing.assert_allclose(m["bit_per_param"], float(m_j["bpp"]),
                                   rtol=1e-4)
    _check_step(results, p_j, b_j, cfg_t, with_stats)


def test_sharded_densify_matches_jax(rng):
    """`make_sharded_densify` from a matched state (statistics drawn from
    a seed, the JAX package's keep draws handed to each rank): the grown
    and pruned counts equal, and the grown anchors, alive masks and
    features equal."""
    jc, cfg_t = _configs(densify_grad_threshold=1e-4, update_interval=4,
                         success_threshold=0.1)
    p, b, voxel = _jax_model(rng)
    # balanced slabs: every shard has free slots to grow into
    p, b, _, _ = jsh.reshard_anchors(_np_tree(p), _np_tree(b),
                                     _np_tree(joptim.init_adam(p)), RANKS,
                                     voxel)
    n, k = p.offsets.shape[:2]
    alive = np.asarray(b.alive)
    # off the voxel grid: at grid positions, anchor / voxel size falls
    # exactly on .5, where XLA's fused division and an op-by-op one may
    # round to different voxel keys
    p = p._replace(anchor=p.anchor + jnp.asarray(
        rng.uniform(-0.01, 0.01, (n, 3)) * alive[:, None], jnp.float32))
    b = b._replace(
        offset_grad_accum=jnp.asarray(
            rng.uniform(0, 1e-3, (n, k)) * alive[:, None], jnp.float32),
        offset_denom=jnp.asarray(rng.integers(0, 3, (n, k)) * alive[:, None],
                                 jnp.float32),
        opacity_accum=jnp.asarray(rng.uniform(0, 0.01, n) * alive,
                                  jnp.float32),
        anchor_denom=jnp.asarray(rng.integers(0, 4, n) * alive, jnp.float32))
    adam = joptim.init_adam(p)
    key = jax.random.PRNGKey(99)
    mesh = jsh.make_mesh(RANKS)
    sp, sb, sa, _ = jsh.shard_model(mesh, p, b, adam)
    p_j, b_j, _, grown, pruned, ovf = jsh.make_sharded_densify(
        jc, mesh, voxel)(sp, sb, sa, key)
    nk = n // RANKS * k
    draws = [_t(np.stack([np.asarray(jax.random.uniform(kk, (nk,)))
                          for kk in jax.random.split(
                              jax.random.fold_in(key, r),
                              cfg_t.model.update_depth)]))
             for r in range(RANKS)]
    results = _spawn(_job(cfg_t, _port_state(p, b, adam, cfg_t), voxel,
                          "plain", [dict(kind="densify", draws=draws)]))
    got = results[0]["densify"][0]
    assert int(grown) > 10 and int(pruned) > 0 and not bool(ovf)
    assert got == dict(n_grown=int(grown), n_pruned=int(pruned),
                       overflowed=False)
    full = _full(results)
    np.testing.assert_array_equal(full["b.alive"], np.asarray(b_j.alive))
    live = np.asarray(b_j.alive)
    for name in ("anchor", "anchor_feat", "scaling_log", "offsets"):
        np.testing.assert_allclose(full[f"p.{name}"][live],
                                   np.asarray(getattr(p_j, name))[live],
                                   atol=1e-6, err_msg=name)


def test_sharded_run_through_densify_tracks_single_process(rng):
    """8 plain steps with the statistics on and a densify after the 5th,
    followed by the reshard, on 4 ranks (balanced by a reshard first)
    against the port's single-process step and `adjust_anchors` from the
    same state, with the JAX package's bounds (tests/test_sharded.py): the
    losses within 1e-4 before the densify and 5% after, and the alive
    anchors within max(3, 25% of the grown)."""
    _, cfg_t = _configs(lambda_dssim=0.0, densify_grad_threshold=1e-4,
                        update_interval=4, success_threshold=0.1)
    p, b, voxel = _jax_model(rng)
    adam = joptim.init_adam(p)
    gt = rng.random((3, H, W)).astype(np.float32)
    cam = make_test_camera(width=W, height=H).as_device_dict()
    n_steps, densify_at = 8, 4

    params, buffers, tadam = _port_state(p, b, adam, cfg_t)
    step = tstep.make_train_step(cfg_t, W, H, "plain", 1.0)
    losses1 = []
    for s in range(n_steps):
        params, buffers, tadam, m = step(params, buffers, tadam, cam, _t(gt),
                                         torch.zeros(3), 50 + s, True)
        losses1.append(float(m.loss))
        if s == densify_at:
            res = tdensify.adjust_anchors(params, buffers, tadam,
                                          cfg_t.model, cfg_t.opt, voxel,
                                          torch.Generator().manual_seed(99))
            params, buffers, tadam = res.params, res.buffers, res.adam
            grown1 = int(res.n_grown)
    n1 = int(buffers.alive.sum())

    state = tsh.reshard_anchors(*_port_state(p, b, adam, cfg_t), RANKS,
                                voxel)[:3]
    actions = []
    for s in range(n_steps):
        actions.append(dict(kind="step", it=50 + s, with_stats=True))
        if s == densify_at:
            actions += [dict(kind="densify"), dict(kind="reshard")]
    results = _spawn(_job(cfg_t, state, voxel, "plain", actions, gt=gt,
                          cam=cam))
    losses8 = [m["loss"] for m in results[0]["metrics"]]
    grown8 = results[0]["densify"][0]["n_grown"]
    n8 = int(_full(results)["b.alive"].sum())
    assert grown1 > 0 and grown8 > 0
    assert abs(n8 - n1) <= max(3, int(0.25 * grown1)), (n1, n8, grown1,
                                                         grown8)
    pre = np.abs(np.array(losses1[:densify_at + 1])
                 - np.array(losses8[:densify_at + 1]))
    assert pre.max() < 1e-4, (losses1, losses8)
    post = np.array(losses1[densify_at + 1:])
    rel = np.abs(post - np.array(losses8[densify_at + 1:])) / np.abs(post)
    assert rel.max() < 0.05, (losses1, losses8)


# ------------------------------------------------------------- the driver

SCENE = ["--res", "32", "--cams", "6", "--gauss", "600", "--points", "200",
         "--force_cpu"]
SCHEDULE = ["--iterations", "20", "--noise_from", "6", "--context_from",
            "12", "--start_stat", "2", "--update_from", "4",
            "--update_interval", "5", "--update_until", "15",
            "--n_offsets", "4", "--checkpoint_iterations", "20"]
RUN_MAIN = textwrap.dedent("""
    import json, sys, torch
    torch.set_num_threads(2)
    from contextgs_tpu_torch.drivers import {module}
    code = {module}.main({argv!r})
    print(json.dumps(dict(code=code, jax="jax" in sys.modules,
                          PIL="PIL" in sys.modules)))
""")


def _run(module, argv, timeout=TIMEOUT):
    out = subprocess.run(
        [sys.executable, "-c", RUN_MAIN.format(module=module, argv=argv)],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_train_driver_mesh_on_the_cpu(tmp_path):
    """`drivers.train --mesh 2 --mesh_force_cpu` on a tiny synthetic scene:
    both ranks train all three phases, rank 0 writes the checkpoint, the
    snapshot and the log, and the gathered model encodes and decodes
    exactly ("decoded" = "ours"); `drivers.test` reads the checkpoint."""
    from contextgs_tpu_torch.scripts import make_synth_scene
    scene, model = tmp_path / "scene", tmp_path / "model"
    assert make_synth_scene.main(["--out", str(scene), *SCENE]) == 0
    got = _run("train", ["-s", str(scene), "-m", str(model), *SCHEDULE,
                         "--mesh", "2", "--mesh_force_cpu"])
    assert got == dict(code=0, jax=False, PIL=False)
    res = json.loads((model / "results.json").read_text())
    assert np.isfinite(res["ours"]["PSNR"]) and res["ours"]["size_MB"] > 0
    assert (model / "chkpnt20.pt").exists()
    assert (model / "point_cloud" / "iteration_20" / "point_cloud.ply") \
        .exists()
    log = (model / "outputs.log").read_text()
    assert "sharded init" in log and "level scales" in log
    meta = torch.load(model / "chkpnt20.pt", weights_only=False)["meta"]
    assert meta["n_devices"] == 2 and meta["iteration"] == 20
    got = _run("decompress", ["-s", str(scene), "-m", str(model),
                              "--force_cpu"])
    assert got["code"] == 0
    got = _run("test", ["-s", str(scene), "-m", str(model), "--force_cpu"])
    assert got["code"] == 0
    res = json.loads((model / "results.json").read_text())
    for name in ("decoded", "ours_from_ckpt"):
        for k in ("PSNR", "SSIM"):
            assert res[name][k] == res["ours"][k], (name, k)


@pytest.mark.parametrize("writer", ["sharded", "single"])
def test_either_loop_resumes_the_others_checkpoint(tmp_path, writer):
    """A checkpoint at step 4 (the first context step, one of the 5
    cameras pending) of one loop, 2 CPU ranks or one process, resumed by
    the other to step 8: the resumed steps' losses are finite, and the
    resumed run's checkpoint at 8 holds the iteration, the level scales,
    the pending camera order and the camera RNG state of the writer's own
    checkpoint at 8."""
    from contextgs_tpu_torch.scene.dataset_readers import load_scene
    from contextgs_tpu_torch.scripts import make_synth_scene
    from contextgs_tpu_torch.train import loop
    root = tmp_path / "scene"
    assert make_synth_scene.main(["--out", str(root), *SCENE]) == 0
    scene = load_scene(str(root))
    opt = tcfg.OptimizationConfig(iterations=8, noise_from=2, context_from=3,
                                  update_from=100)
    model = tcfg.ModelConfig(**MODEL_KW)

    def run(loop_name, model_path, checkpoints, start=""):
        cfg = tcfg.TrainConfig(model=model, opt=opt, model_path=model_path,
                               checkpoint_iterations=checkpoints,
                               save_iterations=(), start_checkpoint=start,
                               log_every=1000)
        if loop_name == "sharded":
            ts = train_sharded(cfg, scene, 2, device="cpu", timeout=TIMEOUT)
            return [s["loss"] for s in ts.ranks[0]["steps"]]
        losses = []
        loop.train(cfg, scene, device="cpu",
                   callback=lambda it, ts, m: losses.append(float(m.loss)))
        return losses

    reader = "single" if writer == "sharded" else "sharded"
    a, b = tmp_path / "a", tmp_path / "b"
    assert len(run(writer, str(a), (4, 8))) == 8
    losses = run(reader, str(b), (8,), start=str(a / "chkpnt4.pt"))
    assert len(losses) == 4 and np.isfinite(losses).all()
    want, got = (torch.load(path / "chkpnt8.pt", weights_only=False)["meta"]
                 for path in (a, b))
    assert got["iteration"] == want["iteration"] == 8
    assert got["level_scales"] == want["level_scales"] is not None
    assert len(want["level_scales"]) == model.level_num - 1
    assert len(scene.train_cameras) == 5
    assert got["cam_order"] == want["cam_order"]
    assert len(got["cam_order"]) == 2
    assert got["rng_state"] == want["rng_state"]
    assert ("n_devices" in got) == (reader == "sharded")


def test_mesh_without_cards_raises(tmp_path, monkeypatch):
    """`--mesh 2` without `--mesh_force_cpu` needs cards: without one the
    driver raises, and with fewer cards than ranks `train_sharded` raises
    with the reason before it spawns anything."""
    from contextgs_tpu_torch.drivers import train as train_driver
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_driver.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"),
                           "--mesh", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spawned = []
    monkeypatch.setattr(comm, "spawn", lambda *a, **k: spawned.append(a))
    _, cfg_t = _configs()
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        train_sharded(cfg_t, None, 2, device="cuda")
    assert spawned == []


def test_a_failing_rank_fails_the_caller():
    """A rank that raises ends the spawn with its traceback, and the other
    rank, blocked in a collective, is ended too."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        comm.spawn(comm.check_collectives, 2, (1,), backend="gloo",
                   device_type="cpu", timeout=TIMEOUT)


def test_comm_collectives_on_two_ranks():
    """all_gather (rank-major, with its summing backward), psum_scatter
    and booleans through gloo on 2 ranks."""
    results = comm.spawn(comm.check_collectives, 2, (), backend="gloo",
                         device_type="cpu", timeout=TIMEOUT)
    for r, res in enumerate(results):
        assert res["gathered"].tolist() == [0.0, 1.0, 10.0, 11.0]
        # d/dx of Σ_ranks Σ (rank+1)·gathered = Σ_ranks (rank+1) = 3
        assert res["grad"].tolist() == [3.0, 3.0]
        assert res["psum_scatter"].tolist() == [2 * (2 * r), 2 * (2 * r + 1)]
        assert res["bools"].tolist() == [True, False, False, True]
