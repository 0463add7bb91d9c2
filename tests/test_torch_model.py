"""PyTorch port against the JAX reference: quantizers, MLPs carried across by
`convert.py`, the neural-gaussian decode, prefilter, `render(phase="plain")`
and `init_scene_model`, on the same numpy inputs (CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu import config as jcfg
from contextgs_tpu.models import decode as jdecode
from contextgs_tpu.models import mlps as jmlps
from contextgs_tpu.models import quant as jquant
from contextgs_tpu.models import renderer as jrenderer
from contextgs_tpu.models import state as jst
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.models import decode as tdecode
from contextgs_tpu_torch.models import mlps as tmlps
from contextgs_tpu_torch.models import quant as tquant
from contextgs_tpu_torch.models import renderer as trenderer
from contextgs_tpu_torch.models import state as tst

from utils_synthetic import make_test_camera

torch.set_num_threads(1)

CFG_KW = dict(feat_dim=8, n_offsets=4, hyper_divisor=4, level_num=3,
              voxel_size=0.08)
W, H = 64, 48


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=2)
def _jax_scene(use_feat_bank=False):
    """JAX-built state with random features and offsets (seeded numpy)."""
    rng = np.random.default_rng(3)
    cfg = jcfg.ModelConfig(**CFG_KW, use_feat_bank=use_feat_bank)
    pts = rng.uniform(-0.6, 0.6, (200, 3)) + np.array([0, 0, 2.5])
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0), pts, cfg)
    p = model.params
    p = p._replace(
        anchor_feat=jnp.asarray(rng.normal(size=p.anchor_feat.shape),
                                jnp.float32),
        offsets=jnp.asarray(rng.normal(size=p.offsets.shape) * 0.2,
                            jnp.float32),
        mask_logit=jnp.asarray(rng.normal(size=p.mask_logit.shape) * 3,
                               jnp.float32))
    return cfg, p, model.buffers


def _torch_scene(use_feat_bank=False):
    cfg_j, p, b = _jax_scene(use_feat_bank)
    cfg_t = tcfg.ModelConfig(**CFG_KW, use_feat_bank=use_feat_bank)
    return (cfg_t, convert.params_from_numpy(_np_tree(p), cfg_t, "cpu"),
            convert.buffers_from_numpy(_np_tree(b), "cpu"))


def test_quantize_anchor_and_mask_ste_exact(rng):
    anchors = rng.uniform(-3, 5, (500, 3)).astype(np.float32)
    bmin = np.float32([[-2.5, -3.1, 0.2]])
    bmax = np.float32([[4.2, 1.7, 3.9]])                # some anchors clip
    deq_j, codes_j = jquant.quantize_anchor(*map(jnp.asarray,
                                                 (anchors, bmin, bmax)))
    deq_t, codes_t = tquant.quantize_anchor(_t(anchors), _t(bmin), _t(bmax))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(deq_t.numpy(), np.asarray(deq_j))
    assert codes_t.max() == 2 ** 16 - 1 and codes_t.min() == 0
    # logits around the 0.01 threshold, sigmoid(-4.595) ≈ 0.01
    logits = np.concatenate([rng.normal(size=300) * 4,
                             -4.595 + rng.normal(size=200) * 1e-3])
    logits = logits.astype(np.float32)
    np.testing.assert_array_equal(
        tquant.mask_ste(_t(logits)).numpy(),
        np.asarray(jquant.mask_ste(jnp.asarray(logits))))


@pytest.mark.parametrize("use_feat_bank", [False, True])
def test_mlps_carried_by_convert(rng, use_feat_bank):
    cfg_j = jcfg.ModelConfig(**CFG_KW, use_feat_bank=use_feat_bank)
    cfg_t = tcfg.ModelConfig(**CFG_KW, use_feat_bank=use_feat_bank)
    mj = jmlps.init_decoder_mlps(jax.random.PRNGKey(5), cfg_j)
    mt = convert.mlps_from_numpy(_np_tree(mj), cfg_t, "cpu")
    x = rng.normal(size=(64, cfg_j.feat_dim + 4)).astype(np.float32)
    for jf, tf in ((jmlps.apply_opacity, tmlps.apply_opacity),
                   (jmlps.apply_cov, tmlps.apply_cov),
                   (jmlps.apply_color, tmlps.apply_color)):
        np.testing.assert_allclose(tf(mt, _t(x)).detach().numpy(),
                                   np.asarray(jf(mj, jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    if use_feat_bank:
        xb = x[:, :4]
        np.testing.assert_allclose(
            tmlps.apply_feature_bank(mt, _t(xb)).detach().numpy(),
            np.asarray(jmlps.apply_feature_bank(mj, jnp.asarray(xb))),
            rtol=1e-6, atol=1e-6)
    grid_in = [g.l1.w.shape[0] for g in mj.grid]
    assert [g.l1.in_features for g in mt.grid] == grid_in


@pytest.mark.parametrize("use_feat_bank", [False, True])
def test_decode_neural_gaussians_matches_jax(rng, use_feat_bank):
    cfg_j, pj, bj = _jax_scene(use_feat_bank)
    cfg_t, pt, bt = _torch_scene(use_feat_bank)
    n = pj.anchor.shape[0]
    vis = rng.random(n) < 0.8
    center = np.float32([0.1, -0.2, 0.0])
    ng_j = jax.jit(lambda p, b, v: jdecode.decode_neural_gaussians(
        p, b, cfg_j, jnp.asarray(center), v, feat=p.anchor_feat,
        grid_scaling=jst.get_scaling(p), grid_offsets=p.offsets,
        anchor=jst.get_anchor(p, b)))(pj, bj, vis)
    with torch.no_grad():
        ng_t = tdecode.decode_neural_gaussians(
            pt, bt, cfg_t, _t(center), _t(vis), feat=pt.anchor_feat,
            grid_scaling=tst.get_scaling(pt), grid_offsets=pt.offsets,
            anchor=tst.get_anchor(pt, bt))
    for name in ("xyz", "color", "opacity", "scaling", "rot",
                 "neural_opacity"):
        np.testing.assert_allclose(getattr(ng_t, name).numpy(),
                                   np.asarray(getattr(ng_j, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("gauss_valid", "anchor_visible"):
        np.testing.assert_array_equal(getattr(ng_t, name).numpy(),
                                      np.asarray(getattr(ng_j, name)),
                                      err_msg=name)
    assert 0 < ng_t.gauss_valid.sum() < ng_t.gauss_valid.numel()


def _cam_dict():
    cam = make_test_camera(width=W, height=H, fov=1.2)
    return cam.as_device_dict()


def test_prefilter_voxel_matches_jax():
    _, pj, bj = _jax_scene()
    _, pt, bt = _torch_scene()
    cd = _cam_dict()
    want = np.asarray(jax.jit(lambda p, b, c: jrenderer.prefilter_voxel(
        p, b, c, W, H))(pj, bj, {k: jnp.asarray(v) for k, v in cd.items()}))
    got = trenderer.prefilter_voxel(pt, bt, cd, W, H).numpy()
    assert 0 < want.sum() < len(want)        # padded dead slots are culled
    np.testing.assert_array_equal(got, want)


def test_render_plain_matches_jax():
    cfg_j, pj, bj = _jax_scene()
    cfg_t, pt, bt = _torch_scene()
    cd = _cam_dict()
    bg = np.float32([0.1, 0.0, 0.3])
    pipe_j = jcfg.PipelineConfig(backend="reference", chunk_size=128)
    out_j = jax.jit(lambda p, b, c: jrenderer.render(
        p, b, cfg_j, jcfg.OptimizationConfig(), pipe_j, c, W, H,
        jnp.asarray(bg), jax.random.PRNGKey(0), phase="plain",
        training=False, budget=1 << 14))(
            pj, bj, {k: jnp.asarray(v) for k, v in cd.items()})
    assert not bool(out_j.overflowed)
    with torch.no_grad():
        out_t = trenderer.render(pt, bt, cfg_t, tcfg.OptimizationConfig(),
                                 tcfg.PipelineConfig(), cd, W, H, _t(bg),
                                 phase="plain")
    img = out_t.image.numpy()
    assert np.abs(img - bg[:, None, None]).max() > 0.1     # not empty
    np.testing.assert_allclose(img, np.asarray(out_j.image), atol=2e-5)
    np.testing.assert_allclose(out_t.final_t.numpy(),
                               np.asarray(out_j.final_t), atol=2e-5)
    assert out_t.n_instances == int(out_j.n_instances)
    with pytest.raises(NotImplementedError, match="slice 2"):
        trenderer.render(pt, bt, cfg_t, tcfg.OptimizationConfig(),
                         tcfg.PipelineConfig(), cd, W, H, _t(bg),
                         phase="noise")


@pytest.mark.parametrize("voxel_size", [0.08, 0.0])
def test_init_scene_model_matches_jax(rng, voxel_size):
    pts = rng.uniform(-0.6, 0.6, (300, 3)) + np.array([0, 0, 2.5])
    kw = dict(CFG_KW, voxel_size=voxel_size)
    mj, vj = jst.init_scene_model(jax.random.PRNGKey(0), pts,
                                  jcfg.ModelConfig(**kw))
    mt, vt = tst.init_scene_model(pts, tcfg.ModelConfig(**kw),
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    assert vt == vj
    for obj_j, obj_t, names in (
            (mj.params, mt.params, ("anchor", "scaling_log", "mask_logit",
                                    "offsets", "anchor_feat", "rotation",
                                    "opacity_raw")),
            (mj.buffers, mt.buffers, ("alive", "bound_min", "bound_max"))):
        for name in names:
            np.testing.assert_allclose(getattr(obj_t, name).numpy(),
                                       np.asarray(getattr(obj_j, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    assert mt.params.prior is None
    n = int(mt.buffers.alive.sum())
    w = mt.params.mlps.opacity.l1.weight
    assert 0 < n < len(mt.buffers.alive) and w.abs().max() <= 1 / 12 ** 0.5
