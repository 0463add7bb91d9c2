"""PyTorch port against the JAX reference: learning-rate schedules, Adam,
densification statistics and `adjust_anchors`, one training step in the
plain phase, and the port's own training loop (phases, densification,
resume, evaluation) on a tiny synthetic scene (CPU)."""

import functools
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import profile

from contextgs_tpu import config as jcfg
from contextgs_tpu.models import densify as jdensify
from contextgs_tpu.models import state as jst
from contextgs_tpu.train import optim as joptim
from contextgs_tpu.train import step as jstep
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.models import densify as tdensify
from contextgs_tpu_torch.models import state as tst
from contextgs_tpu_torch.ops import rasterize as trz
from contextgs_tpu_torch.scene.cameras import make_camera
from contextgs_tpu_torch.scene.dataset_readers import SceneInfo
from contextgs_tpu_torch.scene.ply_io import read_ply
from contextgs_tpu_torch.train import loop as tloop
from contextgs_tpu_torch.train import optim as toptim
from contextgs_tpu_torch.train import step as tstep
from contextgs_tpu_torch.utils import trace

torch.set_num_threads(1)

CFG_KW = dict(feat_dim=8, n_offsets=4, voxel_size=0.1, update_init_factor=4,
              capacity_headroom=6.0)
OPT_KW = dict(update_interval=100, success_threshold=0.8,
              densify_grad_threshold=0.0002, min_opacity=0.005)
W = H = 32


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_close_to_max(got, want, rel, what):
    """|got − want| ≤ rel · max|want| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), 1e-12)
    err = np.abs(got - want).max(initial=0.0) / scale
    assert err <= rel, f"{what}: {err:.3e} of max |{scale:.3e}|"


def _jax_leaves(params_np, cfg_t):
    """Reference Params (numpy) → {port leaf name: numpy array}."""
    return {name: x.numpy() for name, x in tst.param_leaves(
        convert.params_from_numpy(params_np, cfg_t, "cpu")).items()}


# ---------------------------------------------------------------- optim

@pytest.mark.parametrize("step", [0, 1, 150, 2999, 12_345, 30_000, 40_000])
def test_group_lrs_match_jax(step):
    opt = tcfg.OptimizationConfig()
    got = toptim.group_lrs(opt, step, 2.5)
    want = joptim.group_lrs(jcfg.OptimizationConfig(),
                            jnp.asarray(step, jnp.float32), 2.5)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(got[name], float(want[name]), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(
        toptim.expon_lr(step, 0.01, 1e-4, lr_delay_steps=500,
                        lr_delay_mult=0.1, step_sub=100),
        float(joptim.expon_lr(jnp.asarray(step, jnp.float32), 0.01, 1e-4,
                              lr_delay_steps=500, lr_delay_mult=0.1,
                              step_sub=100)), rtol=1e-6)


@functools.lru_cache(maxsize=2)
def _jax_model(headroom=6.0, seed=0, n=40):
    rng = np.random.default_rng(seed)
    cfg = jcfg.ModelConfig(**dict(CFG_KW, capacity_headroom=headroom))
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(seed),
                                        rng.uniform(-1, 1, (n, 3)), cfg)
    return cfg, model, voxel


def _random_like(rng, tree, scale=1.0):
    return jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=np.shape(x)) * scale, jnp.float32), tree)


def test_adam_update_matches_jax(rng):
    cfg_j, model, _ = _jax_model()
    cfg_t = tcfg.ModelConfig(**CFG_KW)
    params = _random_like(rng, model.params)
    grads = _random_like(rng, model.params, 1e-2)
    adam = joptim.AdamState(
        mu=_random_like(rng, model.params, 1e-2),
        nu=jax.tree.map(jnp.abs, _random_like(rng, model.params, 1e-4)),
        count=jnp.asarray(7, jnp.int32))
    opt_j, opt_t = jcfg.OptimizationConfig(), tcfg.OptimizationConfig()
    new_p, new_adam = jax.jit(lambda p, g, a: joptim.adam_update(
        p, g, a, opt_j, jnp.asarray(8.0), 1.7))(params, grads, adam)

    p_t = convert.params_from_numpy(_np_tree(params), cfg_t, "cpu")
    adam_t = convert.adam_from_numpy(_np_tree(adam), cfg_t, "cpu")
    g_t = {name: torch.from_numpy(x) for name, x in
           _jax_leaves(_np_tree(grads), cfg_t).items()}
    p_t, adam_t = toptim.adam_update(p_t, g_t, adam_t, opt_t, 8, 1.7)
    assert adam_t.count == int(new_adam.count) == 8
    for got, want in ((tst.param_leaves(p_t), _np_tree(new_p)),
                      (adam_t.mu, _np_tree(new_adam.mu)),
                      (adam_t.nu, _np_tree(new_adam.nu))):
        want = _jax_leaves(want, cfg_t)
        assert list(got) == list(want)
        for name in got:
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    # the frozen leaves do not move
    for name in ("rotation", "opacity_raw", "anchor"):
        np.testing.assert_array_equal(getattr(p_t, name).numpy(),
                                      np.asarray(getattr(params, name)))


def _adam_inputs(grads_of, seed=3, capacity=40):
    """Random CPU leaves of `blank_params`, moments, and gradients for the
    leaves `grads_of` picks ("all": every leaf; "plain": those a plain-phase
    step gives one)."""
    gen = torch.Generator().manual_seed(seed)
    cfg = tcfg.ModelConfig(**CFG_KW)
    params = tst.blank_params(cfg, capacity, generator=gen, device="cpu")
    leaves = tst.param_leaves(params)
    for x in leaves.values():
        x.copy_(torch.randn(x.shape, generator=gen))

    def like(x, scale):
        return torch.randn(x.shape, generator=gen) * scale

    state = toptim.AdamState(
        mu={n: like(x, 1e-2) for n, x in leaves.items()},
        nu={n: like(x, 1e-2) ** 2 for n, x in leaves.items()}, count=4)
    plain = [n for n in leaves if n not in ("hyper_latent", "rotation",
                                            "opacity_raw")
             and not n.startswith(("mlps.grid.", "prior."))]
    grads = {n: like(leaves[n], 1e-2)
             for n in (leaves if grads_of == "all" else plain)}
    return params, grads, state


@pytest.mark.parametrize("grads_of", ["all", "plain"])
def test_adam_update_on_cpu_runs_the_chain(grads_of, monkeypatch):
    """On CPU tensors `adam_update` is `chain_update` leaf by leaf, bit for
    bit, and never reaches the kernel: the JAX comparisons above hold the
    plain version."""
    def no_kernel(*args):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(toptim, "c_function", no_kernel)
    params, grads, state = _adam_inputs(grads_of)
    opt = tcfg.OptimizationConfig()
    want = {n: (x.clone(), state.mu[n].clone(), state.nu[n].clone())
            for n, x in tst.param_leaves(params).items()}
    before = toptim.launches
    params, state = toptim.adam_update(params, grads, state, opt, 1600, 3.7)
    assert toptim.launches == before and state.count == 5
    lrs = toptim.group_lrs(opt, 1600, 3.7)
    bc1, bc2 = toptim.bias_corrections(5, 0.9, 0.999)
    for name, (p, m, v) in want.items():
        toptim.chain_update(p, grads.get(name), m, v,
                            toptim.leaf_lr(name, lrs), 0.9, 0.999, bc1, bc2,
                            1e-15)
    for name, x in tst.param_leaves(params).items():
        for got, ref in ((x, want[name][0]), (state.mu[name], want[name][1]),
                         (state.nu[name], want[name][2])):
            assert torch.equal(got, ref), name


@pytest.mark.parametrize("grads_of", ["all", "plain"])
def test_adam_update_counts_its_elements(grads_of):
    """Under a recording profiler `adam_elems` counts every element of every
    leaf, with a gradient or without; on the CPU `adam_card_elems` counts 0.
    Without a profiler nothing is counted."""
    params, grads, state = _adam_inputs(grads_of)
    total = sum(x.numel() for x in tst.param_leaves(params).values())
    opt = tcfg.OptimizationConfig()
    trace.take()
    toptim.adam_update(params, grads, state, opt, 1600, 3.7)
    assert trace.take().counts == []
    with profile():
        toptim.adam_update(params, grads, state, opt, 1601, 3.7)
    counts = {}
    for c in trace.take().counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    assert counts == {"adam_elems": total, "adam_card_elems": 0}


@pytest.mark.parametrize("fault", [None, "no_grad", "grad_view", "dtype",
                                   "shape", "device", "param_view"])
def test_kernel_takes_only_contiguous_float32_leaves_of_one_shape(fault):
    """What the kernel is handed of a CUDA leaf: p, m, v and a gradient
    (where there is one) float32 of p's shape on the device of the launch,
    p, m and v contiguous, else ValueError; a gradient that is a view is
    handed over as a contiguous copy, a contiguous one as it is."""
    p, m, v, g = (torch.arange(24.0).reshape(6, 4) for _ in range(4))
    device = torch.device("cpu")
    if fault == "no_grad":
        g = None
    elif fault == "grad_view":
        g = torch.arange(24.0).reshape(4, 6).t()
    elif fault == "dtype":
        m = m.double()
    elif fault == "shape":
        v = v.reshape(4, 6)
    elif fault == "device":
        device = torch.device("meta")
    elif fault == "param_view":
        p = torch.zeros(4, 6).t()
    if fault in ("dtype", "shape", "device", "param_view"):
        with pytest.raises(ValueError):
            toptim._kernel_leaf("offsets", p, g, m, v, device)
        return
    got = toptim._kernel_leaf("offsets", p, g, m, v, device)
    if fault == "no_grad":
        assert got is None
    elif fault == "grad_view":
        assert got.is_contiguous() and torch.equal(got, g)
    else:
        assert got is g


# -------------------------------------------------------------- densify

def test_accumulate_stats_matches_jax(rng):
    _, model, _ = _jax_model()
    b = model.buffers
    n, k = b.offset_grad_accum.shape
    b = b._replace(opacity_accum=jnp.asarray(rng.uniform(0, 3, n),
                                             jnp.float32))
    args = (rng.normal(size=n * k).astype(np.float32),
            rng.random(n * k) < 0.7, rng.random(n * k) < 0.8,
            rng.random(n) < 0.6,
            rng.normal(size=(n * k, 2)).astype(np.float32) * 1e-3)
    want = jdensify.accumulate_stats(b, *map(jnp.asarray, args), k)
    got = tdensify.accumulate_stats(
        convert.buffers_from_numpy(_np_tree(b), "cpu"), *map(_t, args), k)
    for name in ("opacity_accum", "anchor_denom", "offset_grad_accum",
                 "offset_denom"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


def _densify_inputs(rng, headroom):
    """A state whose gradients pass the threshold on about half the offsets,
    displaced so that candidates leave the occupied voxels, with random
    Adam moments and opacity statistics that prune about a quarter."""
    cfg, model, voxel = _jax_model(headroom)
    p, b = model.params, model.buffers
    n, k = b.offset_grad_accum.shape
    alive = np.asarray(b.alive)
    p = p._replace(
        offsets=jnp.asarray(rng.normal(size=(n, k, 3)) * 3, jnp.float32),
        anchor_feat=jnp.asarray(rng.normal(size=p.anchor_feat.shape),
                                jnp.float32),
        hyper_latent=jnp.asarray(rng.normal(size=p.hyper_latent.shape),
                                 jnp.float32),
        scaling_log=jnp.asarray(rng.uniform(-3, 0.3, (n, 6)), jnp.float32))
    grad = np.where(rng.random((n, k)) < 0.5, 1.0, 1e-5) * alive[:, None]
    opac = np.where(rng.random(n) < 0.25, 0.0, 10.0)
    b = b._replace(
        offset_grad_accum=jnp.asarray(grad * 100, jnp.float32),
        offset_denom=jnp.asarray(100.0 * alive[:, None] * np.ones((n, k)),
                                 jnp.float32),
        opacity_accum=jnp.asarray(opac * alive, jnp.float32),
        anchor_denom=jnp.asarray(100.0 * alive, jnp.float32))
    adam = joptim.AdamState(mu=_random_like(rng, p),
                            nu=_random_like(rng, p),
                            count=jnp.asarray(3, jnp.int32))
    return cfg, voxel, p, b, adam


@pytest.mark.parametrize("headroom", [6.0, 1.0])
def test_adjust_anchors_matches_jax(rng, monkeypatch, headroom):
    """Same draws on both sides: alive mask, grown and pruned counts and the
    overflow flag exact, values 1e-6 (headroom 1 overflows the pool)."""
    cfg_j, voxel, p, b, adam = _densify_inputs(rng, headroom)
    cfg_t = tcfg.ModelConfig(**dict(CFG_KW, capacity_headroom=headroom))
    opt_j, opt_t = (jcfg.OptimizationConfig(**OPT_KW),
                    tcfg.OptimizationConfig(**OPT_KW))
    key = jax.random.PRNGKey(4)
    nk = b.offset_grad_accum.size
    keys = jax.random.split(key, cfg_j.update_depth)
    draws = np.stack([np.asarray(jax.random.uniform(kk, (nk,)))
                      for kk in keys])
    monkeypatch.setattr(tdensify, "keep_draws",
                        lambda gen, depth, n, dev: torch.from_numpy(draws))

    want = jax.jit(lambda p, b, a, key: jdensify.adjust_anchors(
        p, b, a, cfg_j, opt_j, voxel, key))(p, b, adam, key)
    got = tdensify.adjust_anchors(
        convert.params_from_numpy(_np_tree(p), cfg_t, "cpu"),
        convert.buffers_from_numpy(_np_tree(b), "cpu"),
        convert.adam_from_numpy(_np_tree(adam), cfg_t, "cpu"),
        cfg_t, opt_t, voxel)

    np.testing.assert_array_equal(got.buffers.alive.numpy(),
                                  np.asarray(want.buffers.alive))
    assert int(got.n_grown) == int(want.n_grown) > 0
    assert int(got.n_pruned) == int(want.n_pruned) > 0
    assert bool(got.overflowed) == bool(want.overflowed) == (headroom == 1.0)
    for name in tst.ANCHOR_FIELDS:
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(want.params, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in tst.Buffers._fields:
        np.testing.assert_allclose(getattr(got.buffers, name).numpy(),
                                   np.asarray(getattr(want.buffers, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for got_m, want_m in ((got.adam.mu, want.adam.mu),
                          (got.adam.nu, want.adam.nu)):
        want_m = _jax_leaves(_np_tree(want_m), cfg_t)
        for name in tst.ANCHOR_FIELDS:
            np.testing.assert_allclose(got_m[name].numpy(), want_m[name],
                                       rtol=1e-6, atol=1e-6, err_msg=name)


# ----------------------------------------------------------- train step

def _scene_cameras(n, rng=None, size=(W, H)):
    cams = []
    for i in range(n):
        ang = (i - 1) * 0.15
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        cams.append(make_camera(i, R, np.zeros(3), 1.0, 1.0, *size))
    return cams


def _render_targets(cams, seed=0, n=60):
    """Targets rendered by the port from a fixed random gaussian set; the
    points are the gaussians' centres."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(1.5, 5.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.05, 0.15, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.6, 1.0, n).astype(np.float32)
    for cam in cams:
        with torch.no_grad():
            img = trz.rasterize(
                *map(torch.from_numpy, (means, scales, quats, colors, opac)),
                world_view=_t(cam.world_view), full_proj=_t(cam.full_proj),
                tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, width=cam.width,
                height=cam.height, bg=torch.zeros(3)).image
        cam.image = np.clip(img.numpy().transpose(1, 2, 0), 0, 1)
    return means


def test_train_step_plain_matches_jax(rng):
    """One step in the plain phase from a mid-training reference state (two
    reference steps build the Adam moments), carried across by convert:
    loss 1e-5 relative; params, moments and densification buffers 1e-5 of
    each leaf's largest value."""
    cams = _scene_cameras(3)
    pts = _render_targets(cams)
    kw = dict(feat_dim=8, n_offsets=4, voxel_size=0.05,
              capacity_headroom=2.0)
    cfg_j = jcfg.TrainConfig(model=jcfg.ModelConfig(**kw),
                             pipe=jcfg.PipelineConfig(backend="reference",
                                                      chunk_size=128))
    cfg_t = tcfg.TrainConfig(model=tcfg.ModelConfig(**kw))
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0), pts,
                                        cfg_j.model)
    p = model.params._replace(anchor_feat=jnp.asarray(
        rng.normal(size=model.params.anchor_feat.shape) * 0.5, jnp.float32))
    b, adam = model.buffers, joptim.init_adam(p)
    step_j = jstep.make_train_step(cfg_j, W, H, 1 << 14, "plain", (), 2.0,
                                   voxel)
    bg = np.zeros(3, np.float32)

    def run_j(p, b, adam, cam, it):
        cd = {k: jnp.asarray(v) for k, v in cam.as_device_dict().items()}
        gt = jnp.asarray(np.transpose(cam.image, (2, 0, 1)))
        return step_j(p, b, adam, cd, gt, jnp.asarray(bg),
                      jnp.asarray(it, jnp.float32), jnp.asarray(True),
                      jax.random.PRNGKey(it))

    for it, cam in ((1, cams[0]), (2, cams[1])):
        p, b, adam, _ = run_j(p, b, adam, cam, it)
    p_t = convert.params_from_numpy(_np_tree(p), cfg_t.model, "cpu")
    b_t = convert.buffers_from_numpy(_np_tree(b), "cpu")
    adam_t = convert.adam_from_numpy(_np_tree(adam), cfg_t.model, "cpu")
    p_j, b_j, adam_j, m_j = run_j(p, b, adam, cams[2], 3)
    step_t = tstep.make_train_step(cfg_t, W, H, "plain", 2.0)
    p_t, b_t, adam_t, m_t = step_t(
        p_t, b_t, adam_t, cams[2].as_device_dict(),
        _t(np.transpose(cams[2].image, (2, 0, 1))), _t(bg), 3, True)

    np.testing.assert_allclose(float(m_t.loss), float(m_j.loss), rtol=1e-5)
    np.testing.assert_allclose(float(m_t.l1), float(m_j.l1), rtol=1e-5)
    assert int(m_t.n_visible_gauss) == int(m_j.n_visible_gauss) > 0
    assert m_t.n_instances == int(m_j.n_instances) > 0
    for got, want in ((tst.param_leaves(p_t), _np_tree(p_j)),
                      (adam_t.mu, _np_tree(adam_j.mu)),
                      (adam_t.nu, _np_tree(adam_j.nu))):
        want = _jax_leaves(want, cfg_t.model)
        for name in got:
            _assert_close_to_max(got[name].numpy(), want[name], 1e-5, name)
    for name in tst.Buffers._fields:
        _assert_close_to_max(getattr(b_t, name).numpy(),
                             np.asarray(getattr(b_j, name)), 1e-5, name)
    assert adam_t.count == int(adam_j.count) == 3
    before = _jax_leaves(_np_tree(p), cfg_t.model)
    for name in ("anchor_feat", "offsets", "mask_logit", "scaling_log",
                 "mlps.opacity.l1.weight", "mlps.cov.l2.bias",
                 "mlps.color.l1.weight"):
        assert np.abs(tst.param_leaves(p_t)[name].numpy()
                      - before[name]).max() > 0, f"{name} did not move"
    assert (float(b_t.offset_grad_accum.max())
            > float(b.offset_grad_accum.max()))


# ---------------------------------------------------------- train loop

def _tiny_scene(n_train=3, n_test=0):
    cams = _scene_cameras(n_train + n_test)
    pts = _render_targets(cams)
    return SceneInfo(points=pts, colors=np.zeros_like(pts),
                     normals=np.zeros_like(pts), train_cameras=cams[:n_train],
                     test_cameras=cams[n_train:], radius=2.0)


def _tiny_cfg(**opt):
    return tcfg.TrainConfig(
        model=tcfg.ModelConfig(feat_dim=8, n_offsets=4, voxel_size=0.05,
                               capacity_headroom=3.0),
        opt=tcfg.OptimizationConfig(**opt), log_every=1000,
        save_iterations=(), **{})


def test_train_plain_and_noise_with_densify(caplog):
    cfg = _tiny_cfg(iterations=30, noise_from=15, context_from=100,
                    start_stat=2, update_from=4, update_interval=10,
                    update_until=25)
    losses, phases = [], []

    def cb(it, ts, metrics):
        losses.append(float(metrics.loss))
        phases.append(tloop.phase_of(it, cfg))

    with caplog.at_level(logging.INFO, logger="contextgs_tpu_torch"):
        ts = tloop.train(cfg, _tiny_scene(), device="cpu", callback=cb)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert phases.count("plain") == 15 and phases.count("noise") == 15
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    densified = [r.message for r in caplog.records if "densify" in r.message]
    assert len(densified) == 2                        # iterations 10 and 20
    assert tst.n_alive(ts.model) > 0 and ts.iteration == 30


def test_train_reaching_context_or_a_snapshot_raises(tmp_path):
    """The context phase runs (it raised before the context slice); a
    snapshot with a model_path, which raised before the drivers slice, now
    writes the training checkpoint and the model snapshot of the final
    state."""
    cfg = _tiny_cfg(iterations=4, noise_from=1, context_from=2)
    bpp = []
    ts = tloop.train(cfg, _tiny_scene(), device="cpu",
                     callback=lambda it, ts, m: bpp.append(
                         float(m.bit_per_param)))
    assert bpp[:2] == [0.0, 0.0] and min(bpp[2:]) > 0
    assert len(ts.level_scales) == cfg.model.level_num - 1
    cfg = tcfg.TrainConfig(model=cfg.model, opt=cfg.opt,
                           model_path=str(tmp_path), save_iterations=(4,),
                           log_every=1000)
    ts = tloop.train(cfg, _tiny_scene(), device="cpu")
    pc_dir = tmp_path / "point_cloud" / "iteration_4"
    assert (tmp_path / "chkpnt4.pt").exists()
    assert {p.name for p in pc_dir.iterdir()} == {
        "point_cloud.ply", "checkpoint.pth", "checkpoint.pth.meta"}
    ply = read_ply(str(pc_dir / "point_cloud.ply"))
    assert len(ply["x"]) == tst.n_alive(ts.model)


def test_train_plain_noise_and_context(caplog):
    """All three phases with densification: finite, falling loss;
    bit_per_param finite and above 0 on every context step; the level scales
    searched once, at the transition; and the model's size estimate."""
    cfg = _tiny_cfg(iterations=40, noise_from=8, context_from=16,
                    start_stat=2, update_from=4, update_interval=10,
                    update_until=30)
    losses, bpp, phases = [], [], []

    def cb(it, ts, metrics):
        losses.append(float(metrics.loss))
        bpp.append(float(metrics.bit_per_param))
        phases.append(tloop.phase_of(it, cfg))

    with caplog.at_level(logging.INFO, logger="contextgs_tpu_torch"):
        ts = tloop.train(cfg, _tiny_scene(), device="cpu", callback=cb)
    assert phases == ["plain"] * 8 + ["noise"] * 8 + ["context"] * 24
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    ctx = np.asarray(bpp[16:])
    assert np.isfinite(ctx).all() and (ctx > 0).all() and bpp[:16] == [0] * 16
    messages = [r.message for r in caplog.records]
    assert sum(m.startswith("level scales") for m in messages) == 1
    assert len(ts.level_scales) == cfg.model.level_num - 1
    assert sum("densify" in m for m in messages) == 2          # 10 and 20
    est = tloop.estimate_bits(ts.model, cfg, ts)
    assert set(est) == {"anchor", "hyper", "feat", "scaling", "offsets",
                        "masks", "mlp", "total"}
    # MB rounded to 4 places: a tiny scene's feat and mask streams round to 0
    assert min(est.values()) >= 0 and est["mlp"] > 0 and est["anchor"] > 0
    assert est["total"] == pytest.approx(
        sum(v for k, v in est.items() if k != "total"), abs=1e-3)


@pytest.mark.parametrize("context_from", [100, 7])
def test_resume_matches_continuous_run(tmp_path, context_from):
    """A run resumed from a checkpoint repeats the continuous run bit for
    bit, through the noise phase and a densification after the resume, and
    (context_from 7) through the context transition: bound refresh, level
    scale search and context steps after the resume."""
    scene = _tiny_scene()
    opt = dict(iterations=10, noise_from=3, context_from=context_from,
               start_stat=1, update_from=4, update_interval=4,
               update_until=100)
    cont = []
    tloop.train(_tiny_cfg(**opt), scene, device="cpu",
                callback=lambda it, ts, m: cont.append(float(m.loss)))
    mp = str(tmp_path / "run")
    resumed = []
    cfg_a = _tiny_cfg(**dict(opt, iterations=5))
    tloop.train(tcfg.TrainConfig(model=cfg_a.model, opt=cfg_a.opt,
                                 model_path=mp, checkpoint_iterations=(5,),
                                 save_iterations=(), log_every=1000),
                scene, device="cpu",
                callback=lambda it, ts, m: resumed.append(float(m.loss)))
    cfg_b = _tiny_cfg(**opt)
    ts = tloop.train(
        tcfg.TrainConfig(model=cfg_b.model, opt=cfg_b.opt, model_path=mp,
                         start_checkpoint=f"{mp}/chkpnt5.pt",
                         save_iterations=(), log_every=1000),
        scene, device="cpu",
        callback=lambda it, ts, m: resumed.append(float(m.loss)))
    assert len(resumed) == len(cont) == 10 and ts.iteration == 10
    np.testing.assert_array_equal(resumed[5:], cont[5:])


@pytest.mark.parametrize("context_from", [100, 7])
def test_resume_builds_no_model_from_points(tmp_path, monkeypatch,
                                            context_from):
    """A resume reads the checkpoint into a structure built from the config
    alone: with `init_scene_model` raising, it repeats the continuous run
    bit for bit, every loss and every leaf of the final model."""
    scene = _tiny_scene()
    opt = dict(iterations=9, noise_from=3, context_from=context_from,
               start_stat=1, update_from=4, update_interval=4,
               update_until=100)
    cont = []
    ts_cont = tloop.train(_tiny_cfg(**opt), scene, device="cpu",
                          callback=lambda it, ts, m: cont.append(
                              float(m.loss)))
    mp = str(tmp_path / "run")
    cfg = _tiny_cfg(**dict(opt, iterations=4))
    tloop.train(tcfg.TrainConfig(model=cfg.model, opt=cfg.opt, model_path=mp,
                                 checkpoint_iterations=(4,),
                                 save_iterations=(), log_every=1000),
                scene, device="cpu")

    def refused(*args, **kw):
        raise AssertionError("a resume built a model from the points")

    monkeypatch.setattr(tst, "init_scene_model", refused)
    cfg = _tiny_cfg(**opt)
    resumed = []
    ts = tloop.train(
        tcfg.TrainConfig(model=cfg.model, opt=cfg.opt,
                         start_checkpoint=f"{mp}/chkpnt4.pt",
                         save_iterations=(), log_every=1000),
        scene, device="cpu",
        callback=lambda it, ts, m: resumed.append(float(m.loss)))
    assert ts.iteration == 9 and len(resumed) == 5
    np.testing.assert_array_equal(resumed, cont[4:])
    assert ts.level_scales == ts_cont.level_scales
    for name, x in tst.param_leaves(ts.model.params).items():
        assert torch.equal(x, tst.param_leaves(ts_cont.model.params)[name]), \
            name
    for name in tst.Buffers._fields:
        assert torch.equal(getattr(ts.model.buffers, name),
                           getattr(ts_cont.model.buffers, name)), name


class _Recorder(tloop.Run):
    """A stand-in for a run that records each event of the schedule as
    (event, iteration, detail): host code, no tensors."""

    METRICS = types.SimpleNamespace(loss=0.5, psnr=20.0, bit_per_param=0.0)

    def __init__(self, ts, sizes):
        self.ts, self.events = ts, []
        self.cams = [types.SimpleNamespace(width=w, height=h)
                     for w, h in sizes]

    def _add(self, event, detail=None):
        self.events.append((event, self.ts.iteration, detail))

    def make_step(self, phase, width, height):
        self._add("make_step", (phase, width, height))
        return phase

    def step(self, fn, ci, it, with_stats):
        self._add("step", (fn, ci, with_stats))
        return self.METRICS

    def enter_context(self):
        self._add("transition")

    def densify(self, it):
        self._add("densify")

    def report(self, it, phase, metrics):
        self._add("report")

    def evaluate(self, it, phase):
        self._add("evaluate")

    def n_alive(self):
        self._add("log")
        return 7

    def save(self, it, order, snapshot):
        self._add("save", snapshot)


def test_schedule_of_a_run():
    """The shared schedule over 4600 steps that cross noise_from,
    context_from and densification's [3000, 4000) gap, driven through a
    recording stand-in: the exact iterations of every phase change, the
    transition, each densification round, log line, checkpoint and
    snapshot; the statistics window; one step function a phase and view
    size; the camera order from `ts.rng`; the order of the events within
    a step; and a resume's pending camera taken first."""
    cfg = tcfg.TrainConfig(
        model=tcfg.ModelConfig(),
        opt=tcfg.OptimizationConfig(
            iterations=4600, noise_from=1000, context_from=3500,
            start_stat=600, update_from=500, update_interval=250,
            update_until=4500),
        log_every=1000, checkpoint_iterations=(1500, 3600),
        save_iterations=(3000, 4600), model_path="unused", seed=7)

    def state(iteration=0):
        return tloop.TrainerState(model=None, adam=None, voxel_size=0.1,
                                  spatial_lr_scale=1.0, generator=None,
                                  iteration=iteration,
                                  rng=np.random.default_rng(cfg.seed))

    ts = state()
    run = _Recorder(ts, [(32, 32), (32, 32), (48, 32)])
    calls = []
    tloop.run_schedule(cfg, ts, run, [],
                       lambda it, ts_, m: calls.append(it)
                       or run._add("callback"))
    assert ts.iteration == 4600 and calls == list(range(1, 4601))

    def at(event):
        return [it for e, it, _ in run.events if e == event]

    steps = {it: d for e, it, d in run.events if e == "step"}
    assert sorted(steps) == list(range(1, 4601))
    phases = [steps[it][0] for it in range(1, 4601)]
    assert [i + 1 for i in range(1, 4600) if phases[i] != phases[i - 1]] \
        == [1001, 3501]
    assert phases[0] == "plain" and phases[-1] == "context"
    assert at("transition") == [3501]
    assert at("densify") == [750, 1000, 1250, 1500, 1750, 2000, 2250, 2500,
                             2750, 4000, 4250]
    assert at("log") == [1000, 2000, 3000, 4000]
    assert [(it, d) for e, it, d in run.events if e == "save"] == [
        (1500, False), (3000, True), (3600, False), (4600, True)]
    assert [it for it in steps if steps[it][2]] == list(range(601, 4500))
    made = [(it, d) for e, it, d in run.events if e == "make_step"]
    assert made == [(1, ("plain", 32, 32)), (made[1][0], ("plain", 48, 32)),
                    (1001, ("noise", made[2][1][1], 32)),
                    (made[3][0], made[3][1]),
                    (3501, ("context", made[4][1][1], 32)),
                    (made[5][0], made[5][1])]
    assert {d for _, d in made} == {(p, w, 32) for p in ("plain", "noise",
                                                         "context")
                                    for w in (32, 48)}
    rng = np.random.default_rng(cfg.seed)
    want = []
    while len(want) < 4600:
        want += [int(i) for i in rng.permutation(3)][::-1]
    assert [steps[it][1] for it in range(1, 4601)] == want[:4600]
    assert [e for e, it, _ in run.events if it == 4000] == [
        "step", "densify", "report", "callback", "evaluate", "log"]
    assert [e for e, it, _ in run.events if it == 3000] == [
        "step", "report", "callback", "evaluate", "log", "save"]
    assert [e for e, it, _ in run.events if it == 3501] == [
        "transition", "make_step", "step", "report", "callback", "evaluate"]

    # a resume at 2999 with camera 1 pending: step 3000 takes it, then a
    # new order from ts.rng
    ts = state(2999)
    run = _Recorder(ts, [(32, 32)] * 3)
    tloop.run_schedule(cfg, ts, run, [1])
    steps = {it: d for e, it, d in run.events if e == "step"}
    assert min(steps) == 3000 and steps[3000][1] == 1
    perm = [int(i) for i in np.random.default_rng(cfg.seed).permutation(3)]
    assert [steps[it][1] for it in (3001, 3002, 3003)] == perm[::-1]


def test_test_iterations_evaluate_every_test_camera(caplog):
    cfg = tcfg.TrainConfig(
        model=_tiny_cfg().model,
        opt=tcfg.OptimizationConfig(iterations=6, noise_from=2,
                                    context_from=4, update_from=100),
        test_iterations=(2, 4, 6), save_iterations=(), log_every=1000)
    with caplog.at_level(logging.INFO, logger="contextgs_tpu_torch"):
        ts = tloop.train(cfg, _tiny_scene(n_train=2, n_test=3), device="cpu")
    lines = [r.message for r in caplog.records if "test [" in r.message]
    assert len(lines) == 3
    assert "test [plain]" in lines[0] and "test [noise]" in lines[1]
    assert "test [context]" in lines[2]
    assert all("over 3 views" in line for line in lines)
    # the context phase's eval quantizes by rounding and draws nothing
    cam = _tiny_scene(n_train=2, n_test=3).test_cameras[0]
    run = tstep.make_eval_render(cfg, cam.width, cam.height, "context",
                                 ts.level_scales, ts.voxel_size)
    bg = torch.zeros(3)
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    images = [run(ts.model.params, ts.model.buffers, cam.as_device_dict(), bg,
                  gen) for _ in range(2)]
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(images[0], images[1]) and float(images[0].sum()) > 0


def test_grow_capacity_pads_the_pool():
    pts = np.random.default_rng(1).uniform(-1, 1, (50, 3))
    cfg = tcfg.ModelConfig(feat_dim=8, n_offsets=4, voxel_size=0.05)
    model, _ = tst.init_scene_model(pts, cfg, device="cpu")
    adam = toptim.init_adam(model.params)
    for moments in (adam.mu, adam.nu):
        for x in moments.values():
            x.uniform_()
    n = model.buffers.alive.shape[0]
    grown, adam2 = tloop.grow_capacity(model, adam, 2 * n)
    for name in tst.ANCHOR_FIELDS:
        x = getattr(grown.params, name)
        assert x.shape[0] == 2 * n and not x[n:].any(), name
        np.testing.assert_array_equal(x[:n].numpy(),
                                      getattr(model.params, name).numpy())
        for moments in (adam2.mu, adam2.nu):
            assert moments[name].shape[0] == 2 * n
            assert not moments[name][n:].any()
    assert grown.buffers.alive.shape[0] == 2 * n
    assert int(grown.buffers.alive.sum()) == int(model.buffers.alive.sum())
    assert adam2.mu["mlps.opacity.l1.weight"] is adam.mu[
        "mlps.opacity.l1.weight"]
    assert tloop.grow_capacity(grown, adam2, n)[0] is grown
