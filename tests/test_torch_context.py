"""PyTorch port against the JAX reference in the context phase: the entropy
models, the factorized prior, the level maps, the multi-level context in eval
and training mode (values and gradients), the rate and size estimates, and
one context-phase training step (CPU). Random numbers are the reference's
own draws, derived from its keys in its split order and handed to the
port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from contextgs_tpu import config as jcfg
from contextgs_tpu.models import context as jctx
from contextgs_tpu.models import entropy as jent
from contextgs_tpu.models import levels as jlev
from contextgs_tpu.models import state as jst
from contextgs_tpu.train import optim as joptim
from contextgs_tpu.train import step as jstep
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.models import context as tctx
from contextgs_tpu_torch.models import entropy as tent
from contextgs_tpu_torch.models import levels as tlev
from contextgs_tpu_torch.models import state as tst
from contextgs_tpu_torch.train import optim as toptim
from contextgs_tpu_torch.train import step as tstep
import carry_cases
from test_torch_train import (W, H, _assert_close_to_max, _jax_leaves,
                              _np_tree, _render_targets, _scene_cameras, _t)

torch.set_num_threads(1)

CFG_KW = dict(feat_dim=8, n_offsets=4, level_num=3, voxel_size=0.05,
              capacity_headroom=1.5)
SCALES = (4.0, 16.0)


def _prior_np(prior):
    return tent.FactorizedPrior(**{
        name: tuple(_t(np.asarray(x)) for x in getattr(prior, name))
        for name in tent.FactorizedPrior._fields})


def _random_prior(rng, channels):
    """The reference's init with every leaf perturbed, so that the factors'
    tanh terms and the biases matter."""
    prior = jent.init_factorized_prior(jax.random.PRNGKey(5), channels)
    return jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(size=x.shape) * 0.3, jnp.float32), prior)


# ------------------------------------------------------------- entropy

# XLA's float32 erf is off by up to 2.2e-7 from the exact value (4-5 ulps
# near 1), torch's by 6e-8. A bin's likelihood is the difference of two
# CDFs, so its absolute error is a few ulps of 1, and the error of its bits
# (and of their gradients, relatively) grows as 1/likelihood.
CDF_ULPS = 8 * 2.0 ** -24


def _assert_bits_close(got, want, lik, what, rel=1e-6, skip=None):
    """|got − want| ≤ rel · max|want| + |want| · CDF_ULPS / lik elementwise
    (for bits, CDF_ULPS / (lik · ln 2)), with lik the likelihood (≥ its 1e-6
    bound); `skip` leaves elements out."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    allowed = rel * scale + CDF_ULPS / np.maximum(lik, 1e-6) * (
        np.abs(want) if what != "bits" else 1 / np.log(2))
    excess = np.abs(got - want) - allowed
    if skip is not None:
        excess = np.where(skip, -1.0, excess)
    assert excess.max() <= 0, (f"{what}: {np.abs(got - want).max():.3e} "
                               f"off, over the bound by {excess.max():.3e}")

def _bits_inputs(rng, n=600):
    x = rng.normal(size=(n, 5)) * 2
    mean = rng.normal(size=(n, 5))
    scale = rng.uniform(0.05, 2.0, (n, 5))
    scale[:20] = rng.uniform(-1e-3, 1e-9, (20, 5))   # the 1e-9 floor
    x[20:60] = mean[20:60] + rng.choice([-1, 1], (40, 5)) * 40   # 1e-6 bound
    q = rng.uniform(0.5, 1.5, (n, 1))
    w = rng.normal(size=(n, 5))
    return [a.astype(np.float32) for a in (x, mean, scale, q, w)]


@pytest.mark.parametrize("with_mean", [False, True])
def test_gaussian_bits_matches_jax(rng, with_mean):
    """Values and gradients in x, mean and scale (the low bound's
    pass-through included: the weights take both signs)."""
    x, mean, scale, q, w = _bits_inputs(rng)
    x_mean = np.float32(0.3) if with_mean else None
    if with_mean:
        x[60:70] = 2e4                    # outside x_mean ± 15000·Q

    def f_j(x, m, s):
        return jnp.sum(jent.gaussian_bits(x, m, s, jnp.asarray(q),
                                          x_mean) * w)

    want = np.asarray(jent.gaussian_bits(*map(jnp.asarray, (x, mean, scale)),
                                         jnp.asarray(q), x_mean))
    grads_j = jax.grad(f_j, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                    (x, mean, scale)))
    xs = [_t(a).requires_grad_(True) for a in (x, mean, scale)]
    got = tent.gaussian_bits(*xs, _t(q), None if x_mean is None
                             else torch.tensor(x_mean))
    grads_t = torch.autograd.grad((got * _t(w)).sum(), xs)
    assert (want > 19.9).any() and (want < 1).any()   # both ends reached
    lik = 2.0 ** -want.astype(np.float64)
    _assert_bits_close(got.detach().numpy(), want, lik, "bits")
    # below 1e-6 + CDF_ULPS the float32 difference of two CDFs is rounding
    # noise, sign included, so a gradient through the bound's pass-through
    # is noise in both packages; the bound is held by low_bound's own check
    xc = x if x_mean is None else np.clip(x, x_mean - 15000 * q,
                                          x_mean + 15000 * q)
    sd = np.maximum(scale.astype(np.float64), 1e-9)
    lik64 = np.abs(scipy.special.ndtr((xc + 0.5 * q - mean) / sd)
                   - scipy.special.ndtr((xc - 0.5 * q - mean) / sd))
    near_bound = lik64 <= 1e-6 + CDF_ULPS
    for name, g_t, g_j in zip(("x", "mean", "scale"), grads_t, grads_j):
        _assert_bits_close(g_t.numpy(), np.asarray(g_j), lik, name,
                           skip=near_bound)
    assert (~near_bound).mean() > 0.7

    v = np.float32([1e-8, 5e-7, 1e-6, 2e-6, 1e-3] * 2)
    g = np.float32([1.0] * 5 + [-1.0] * 5)
    want_lb, vjp = jax.vjp(jent.low_bound, jnp.asarray(v))
    vt = _t(v).requires_grad_(True)
    got_lb = tent.low_bound(vt)
    np.testing.assert_array_equal(got_lb.detach().numpy(), np.asarray(want_lb))
    np.testing.assert_array_equal(
        torch.autograd.grad(got_lb, vt, _t(g))[0].numpy(),
        np.asarray(vjp(jnp.asarray(g))[0]))


def test_factorized_prior_functions_match_jax(rng):
    """factorized_likelihood (values and gradients in x and every prior
    leaf), factorized_forward in eval mode, the PMF table, Bernoulli bits and
    the binary grid size."""
    prior_j = _random_prior(rng, 3)
    prior_t = _prior_np(_np_tree(prior_j))
    x = (rng.normal(size=(200, 3)) * 2).astype(np.float32)
    w = rng.normal(size=(200, 3)).astype(np.float32)

    def f_j(prior, x):
        return jnp.sum(jent.factorized_likelihood(prior, x) * w)

    want = np.asarray(jent.factorized_likelihood(prior_j, jnp.asarray(x)))
    g_prior_j, g_x_j = jax.grad(f_j, argnums=(0, 1))(prior_j, jnp.asarray(x))
    named = {name: x.detach().requires_grad_(True) for name, x in
             tst.param_leaves(tst.Params(*[None] * 8, mlps=torch.nn.Module(),
                                         prior=prior_t)).items()
             if name.startswith("prior.")}
    leaves = list(named.values())          # the reference's leaf order
    xt = _t(x).requires_grad_(True)
    got = tent.factorized_likelihood(tst.prior_from_leaves(named), xt)
    grads_t = torch.autograd.grad((got * _t(w)).sum(), leaves + [xt])
    # the likelihood is a difference of two sigmoids: CDF_ULPS absolute
    _assert_bits_close(got.detach().numpy(), want, want, "likelihood")
    for name, g_t, g_j in zip(named, grads_t, jax.tree.leaves(g_prior_j)):
        _assert_close_to_max(g_t.numpy(), np.asarray(g_j), 1e-5, name)
    _assert_close_to_max(grads_t[-1].numpy(), np.asarray(g_x_j), 1e-5, "x")

    y_j, lik_j = jent.factorized_forward(prior_j, jnp.asarray(x), None, False)
    y_t, lik_t = tent.factorized_forward(prior_t, _t(x), None, False)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    _assert_bits_close(lik_t.numpy(), np.asarray(lik_j), np.asarray(lik_j),
                       "eval likelihood")
    pmf_j = np.asarray(jent.factorized_pmf_table(prior_j, -30, 30))
    _assert_bits_close(tent.factorized_pmf_table(prior_t, -30, 30).numpy(),
                       pmf_j, pmf_j, "pmf")

    sym = np.where(rng.random(300) < 0.3, 1.0, -1.0).astype(np.float32)
    p = rng.uniform(0, 1, 300).astype(np.float32)
    np.testing.assert_allclose(
        tent.bernoulli_bits(_t(sym), _t(p)).numpy(),
        np.asarray(jent.bernoulli_bits(jnp.asarray(sym), jnp.asarray(p))),
        rtol=1e-6)
    mask = (rng.random((50, 4)) < 0.6).astype(np.float32)
    valid = rng.random((50, 1)) < 0.7
    for v in (None, np.broadcast_to(valid, mask.shape)):
        p_j, bits_j = jent.binary_grid_size_bits(
            jnp.asarray(mask), None if v is None else jnp.asarray(v))
        p_t, bits_t = tent.binary_grid_size_bits(
            _t(mask), None if v is None else _t(v))
        np.testing.assert_allclose(float(p_t), float(p_j), rtol=1e-6)
        np.testing.assert_allclose(float(bits_t), float(bits_j), rtol=1e-6)


def test_init_factorized_prior_matches_jax():
    """Shapes and leaf names as the reference's; the matrices are its
    constant init, the factors zero, the biases U(-0.5, 0.5)."""
    want = jent.init_factorized_prior(jax.random.PRNGKey(0), 12)
    got = tent.init_factorized_prior(12, torch.Generator().manual_seed(0),
                                     "cpu")
    assert got._fields == want._fields
    for name in got._fields:
        assert len(getattr(got, name)) == len(getattr(want, name))
        for x_t, x_j in zip(getattr(got, name), getattr(want, name)):
            assert tuple(x_t.shape) == x_j.shape, name
            if name != "biases":
                np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    assert all(float(x.abs().max()) == 0.0 for x in got.factors)
    biases = torch.cat([b.flatten() for b in got.biases])
    assert float(biases.min()) >= -0.5 and float(biases.max()) < 0.5
    assert float(biases.std()) > 0.1


def test_own_init_param_leaves_match_jax_tree():
    """The port's own init has the prior: its leaves' names and shapes
    equal those of the reference's init tree carried across by convert."""
    pts = np.random.default_rng(2).uniform(-1, 1, (80, 3))
    mj, _ = jst.init_scene_model(jax.random.PRNGKey(0), pts,
                                 jcfg.ModelConfig(**CFG_KW))
    mt, _ = tst.init_scene_model(pts, tcfg.ModelConfig(**CFG_KW),
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    want = _jax_leaves(_np_tree(mj.params), tcfg.ModelConfig(**CFG_KW))
    got = tst.param_leaves(mt.params)
    assert list(got) == list(want)
    assert any(name.startswith("prior.biases.") for name in got)
    for name, x in got.items():
        assert tuple(x.shape) == want[name].shape, name


# --------------------------------------------------------------- levels

@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("pattern", carry_cases.PATTERNS + ("long_run",))
def test_segmented_carry_matches_jax(rng, pattern, dtype):
    """The port's CPU path (`segmented_carry_plain`) against the reference's
    associative scan, int64 values under JAX's 64-bit mode: equal integers,
    and values[0] before the first start."""
    n = 12 * carry_cases.TILE + 5
    starts = (carry_cases.long_run(n, rng) if pattern == "long_run"
              else carry_cases.starts(pattern, n, rng))
    values = carry_cases.values(n, dtype, rng)
    with jax.enable_x64(dtype == np.int64):
        want = np.asarray(jax.jit(jlev.segmented_carry)(
            jnp.asarray(starts), jnp.asarray(values)))
    assert want.dtype == dtype
    got = tlev.segmented_carry(torch.from_numpy(starts),
                               torch.from_numpy(values))
    assert got.dtype == torch.from_numpy(values).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if not starts[0]:
        assert (got[:int(np.argmax(starts)) or n] == int(values[0])).all()


@pytest.mark.parametrize("kept_stricter", [False, True])
def test_build_level_maps_matches_jax_exactly(rng, kept_stricter):
    """Duplicate voxels, dead slots, and a member mask stricter than alive:
    level, parent and counts equal the reference's."""
    n = 400
    anchors = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    anchors[100:160] = anchors[:60]                  # duplicate voxels
    anchors[160:200] = anchors[:40] + 1e-3
    alive = rng.random(n) < 0.8
    member = alive & (rng.random(n) < 0.7) if kept_stricter else alive
    want = jlev.build_level_maps(jnp.asarray(anchors), jnp.asarray(member),
                                 0.05, SCALES, 3)
    got = tlev.build_level_maps(_t(anchors), _t(member), 0.05, SCALES, 3)
    for name in ("level", "parent", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    counts = got.counts.numpy()
    assert counts.sum() == member.sum() and (counts > 0).all()


def test_find_divide_scale_matches_jax(rng):
    anchors = rng.uniform(-1, 1, (2000, 3))
    args = (0.01, np.full(3, -1.2), np.full(3, 1.2), 0.2, 3)
    got = tlev.find_divide_scale(anchors, *args)
    assert got == jlev.find_divide_scale(anchors, *args) and len(got) == 2


# -------------------------------------------------------------- context

def _trained_sigmas(mlps, cfg):
    """Set the grid MLPs' σ outputs to 1 ± 0.1, near the spread of the
    coded values, where training brings them. Random weights leave σ near
    0, and most bins then sit in the CDFs' tails (z > 4), where a bin's
    likelihood is a difference of two float32 CDFs near 1, so that its value
    and its gradient carry rounding errors of 1e-3 relative or more (XLA's
    float32 erf is off by up to 2.2e-7, torch's by 6e-8): summed bits then
    differ by 1e-4 relative and the rate's gradients by 1% of their max.
    That regime is held element by element in
    `test_gaussian_bits_matches_jax`."""
    f, k = cfg.feat_dim, cfg.n_offsets
    sigma = np.zeros((f + 6 + 3 * k) * 2 + 3, np.float32)
    sigma[f:2 * f] = 1.0
    sigma[2 * f + 6:2 * f + 12] = 1.0
    sigma[2 * f + 12 + 3 * k:2 * f + 12 + 6 * k] = 1.0
    cols = sigma > 0

    def fix(l2):
        w = np.array(l2.w)
        w[:, cols] *= 0.1
        b = np.where(cols, sigma, np.asarray(l2.b))
        return l2._replace(w=jnp.asarray(w), b=jnp.asarray(b, jnp.float32))

    return mlps._replace(grid=tuple(g._replace(l2=fix(g.l2))
                                    for g in mlps.grid))


@functools.lru_cache(maxsize=1)
def _jax_context_state():
    """A reference state with content in every field the context reads,
    trained-scale σ outputs, a perturbed prior, masks that switch off a
    fifth of the anchors (the kept set is stricter than alive) and dead
    slots."""
    rng = np.random.default_rng(7)
    cfg = jcfg.ModelConfig(**CFG_KW)
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0),
                                        rng.uniform(-1, 1, (300, 3)), cfg)
    p, b = model.params, model.buffers
    n = p.anchor.shape[0]
    alive = np.asarray(b.alive)

    def normal(shape, s):
        return jnp.asarray(rng.normal(size=shape) * s * alive.reshape(
            (-1,) + (1,) * (len(shape) - 1)), jnp.float32)

    mask = np.where(rng.random((n, 1)) < 0.2, -8.0, 2.0) + rng.normal(
        size=(n, cfg.n_offsets))
    p = p._replace(
        anchor_feat=normal(p.anchor_feat.shape, 0.7),
        hyper_latent=normal(p.hyper_latent.shape, 0.7),
        offsets=normal(p.offsets.shape, 0.2),
        scaling_log=p.scaling_log + normal(p.scaling_log.shape, 0.3),
        mask_logit=jnp.asarray(mask * alive[:, None], jnp.float32),
        mlps=_trained_sigmas(p.mlps, cfg),
        prior=_random_prior(rng, cfg.hyper_dim))
    kept = jst.get_mask_anchor(p, b.alive)
    maps = jlev.build_level_maps(jst.get_anchor(p, b), kept, voxel, SCALES,
                                 cfg.level_num)
    assert 0 < int(kept.sum()) < int(b.alive.sum())
    return cfg, p, b, maps, voxel


def _torch_context_state():
    cfg_j, p, b, maps, voxel = _jax_context_state()
    cfg_t = tcfg.ModelConfig(**CFG_KW)
    pt = convert.params_from_numpy(_np_tree(p), cfg_t, "cpu")
    bt = convert.buffers_from_numpy(_np_tree(b), "cpu")
    maps_t = tlev.LevelMaps(*(_t(np.asarray(x)) for x in maps))
    return cfg_t, pt, bt, maps_t


def _uniform(key, shape):
    return _t(np.asarray(jax.random.uniform(key, shape, jnp.float32)))


def _jax_draws(cfg, n, key_levels, key_rate=None):
    """The reference's draws as a `ContextDraws`: multi_scale_generate's key
    split into level_num + 1 (the last for the hyper noise), each level's
    into feat, scaling and offsets; estimate_rate's key for the subsample."""
    keys = jax.random.split(key_levels, cfg.level_num + 1)
    per_level = [jax.random.split(keys[i], 3) for i in range(cfg.level_num)]
    return tctx.ContextDraws(
        hyper=_uniform(keys[-1], (n, cfg.hyper_dim)),
        feat=tuple(_uniform(k[0], (n, cfg.feat_dim)) for k in per_level),
        scaling=tuple(_uniform(k[1], (n, 6)) for k in per_level),
        offsets=tuple(_uniform(k[2], (n, 3 * cfg.n_offsets))
                      for k in per_level),
        rate=None if key_rate is None else _uniform(key_rate, (n,)))


def _outputs(out):
    """ContextOutput → {name: array}, the entropy parameters by field."""
    d = {name: getattr(out, name) for name in ("feat_q", "scaling_q",
                                               "offsets_q", "hyper_q",
                                               "likelihood_hyper")}
    d.update(out.eparams._asdict())
    return d


@pytest.mark.parametrize("disable_hyper", [False, True])
def test_multi_scale_generate_eval_matches_jax(disable_hyper):
    cfg_j, p, b, maps, _ = _jax_context_state()
    cfg_t, pt, bt, maps_t = _torch_context_state()
    want = jax.jit(lambda p, b, m: jctx.multi_scale_generate(
        p, b, cfg_j, m, jst.get_anchor(p, b), jax.random.PRNGKey(0),
        training=False, disable_hyper=disable_hyper))(p, b, maps)
    with torch.no_grad():
        got = tctx.multi_scale_generate(pt, bt, cfg_t, maps_t,
                                        tst.get_anchor(pt, bt), None,
                                        training=False,
                                        disable_hyper=disable_hyper)
    want, got = _outputs(want), _outputs(got)
    assert float(np.abs(np.asarray(want["feat_q"])).max()) > 0.5
    for name in want:
        _assert_close_to_max(got[name].numpy(), np.asarray(want[name]), 1e-5,
                             name)


def _grad_fields(leaves):
    return {name: x for name, x in leaves.items()
            if name in ("anchor_feat", "hyper_latent", "offsets",
                        "scaling_log") or name.startswith(("mlps.grid.",
                                                           "prior."))}


def test_multi_scale_generate_training_matches_jax(rng):
    """Training mode with the reference's draws: every output, and the
    gradients of a random linear functional of all of them in the anchor
    fields, the grid MLPs and the prior, to 1e-5 of max."""
    cfg_j, p, b, maps, _ = _jax_context_state()
    cfg_t, pt, bt, maps_t = _torch_context_state()
    key = jax.random.PRNGKey(11)
    n = p.anchor.shape[0]
    want = jctx.multi_scale_generate(p, b, cfg_j, maps, jst.get_anchor(p, b),
                                     key, training=True)
    # positive weights: with both signs the prior's gradient is a sum of
    # cancelling terms, and its float32 rounding is then 2e-5 of its max
    weights = {name: rng.uniform(0, 1, np.shape(x)).astype(np.float32)
               for name, x in _outputs(want).items()}

    def functional_j(p):
        outs = _outputs(jctx.multi_scale_generate(
            p, b, cfg_j, maps, jst.get_anchor(p, b), key, training=True))
        return sum(jnp.sum(outs[k] * w) for k, w in weights.items())

    grads_j = jax.jit(jax.grad(functional_j))(p)
    draws = _jax_draws(cfg_t, n, key)
    p_g, leaves = tstep._grad_leaves(pt)
    got = _outputs(tctx.multi_scale_generate(
        p_g, bt, cfg_t, maps_t, tst.get_anchor(p_g, bt), draws,
        training=True))
    for name, x in _outputs(want).items():
        _assert_close_to_max(got[name].detach().numpy(), np.asarray(x), 1e-5,
                             name)
    fields = _grad_fields(leaves)
    grads_t = torch.autograd.grad(
        sum((got[k] * _t(w)).sum() for k, w in weights.items()),
        list(fields.values()))
    want_g = _grad_fields(_jax_leaves(_np_tree(grads_j), cfg_t))
    assert list(want_g) == list(fields) and len(fields) > 20
    for (name, g) in zip(fields, grads_t):
        assert float(np.abs(want_g[name]).max()) > 0, name
        _assert_close_to_max(g.numpy(), want_g[name], 1e-5, name)


def test_estimate_rate_and_total_bits_match_jax():
    cfg_j, p, b, maps, _ = _jax_context_state()
    cfg_t, pt, bt, maps_t = _torch_context_state()
    n = p.anchor.shape[0]
    kc, kr = jax.random.PRNGKey(4), jax.random.PRNGKey(5)

    def rate_j(p, b, maps):
        out = jctx.multi_scale_generate(p, b, cfg_j, maps,
                                        jst.get_anchor(p, b), kc,
                                        training=True)
        return jctx.estimate_rate(p, b, cfg_j, out, jst.get_mask(p),
                                  jst.get_mask_anchor(p, b.alive), kr)

    want = jax.jit(rate_j)(p, b, maps)
    draws = _jax_draws(cfg_t, n, kc, kr)
    with torch.no_grad():
        out = tctx.multi_scale_generate(pt, bt, cfg_t, maps_t,
                                        tst.get_anchor(pt, bt), draws, True)
        got = tctx.estimate_rate(pt, bt, cfg_t, out, tst.get_mask(pt),
                                 tst.get_mask_anchor(pt, bt.alive),
                                 draws.rate)
    for name in want._fields:
        assert float(getattr(want, name)) > 0, name
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)

    want = jax.jit(lambda p, b, m: jctx.estimate_total_bits(
        p, b, cfg_j, m, jst.get_anchor(p, b), kc))(p, b, maps)
    with torch.no_grad():
        got = tctx.estimate_total_bits(pt, bt, cfg_t, maps_t,
                                       tst.get_anchor(pt, bt))
    assert set(got) == set(want)
    for name in want:
        assert float(want[name]) > 0, name
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, err_msg=name)


# ------------------------------------------------------------ train step

def _assert_adam_step_close(got, want, mu0, mu, nu, lr, count, name,
                            rel=1e-5):
    """Parameters after an Adam step: |got − want| ≤ rel · max|want| plus
    what a gradient error of rel · max|g| becomes through the step's
    normalisation, lr · |δ(m̂ / √v̂)|, to first order. Adam divides by √v̂,
    so where a leaf's gradient is tiny, rounding the packages share to 1e-5
    of the leaf's largest gradient moves its step by a sizeable fraction."""
    b1, b2 = 0.9, 0.999
    g = (mu - b1 * mu0) / (1 - b1)             # this step's gradient
    dg = rel * np.abs(g).max()
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    nu = np.asarray(nu, np.float64)
    sv = np.sqrt(np.where(nu > 0, nu, 1.0) / bc2)
    step_err = np.where(nu > 0, lr * (
        (1 - b1) * dg / (bc1 * sv)
        + np.abs(mu / bc1) * (1 - b2) * np.abs(g) * dg / (bc2 * sv ** 3)), 0.0)
    allowed = rel * np.abs(want).max() + step_err
    excess = np.abs(np.asarray(got, np.float64) - want) - allowed
    assert excess.max() <= 0, f"{name}: over its bound by {excess.max():.3e}"


def test_train_step_context_matches_jax(rng, monkeypatch):
    """One context-phase step from a mid-training reference state (two
    reference context steps build the Adam moments of every leaf), with the
    reference's draws: loss and bit_per_param 1e-5 relative; Adam moments
    and densification buffers 1e-5 of each leaf's max; params (prior, hyper
    latent and grid MLPs included) 1e-5 of each leaf's max plus what a
    gradient error of that size becomes through Adam's normalisation."""
    cams = _scene_cameras(3)
    pts = _render_targets(cams, n=300)
    # scaling bins of 0.05, not 1e-3, at σ ≈ 1: a 1e-3 bin's likelihood
    # (~4e-4) is a difference of two CDFs, its float32 bits and gradients
    # differ by ~1e-4 relative between the packages, and Adam's
    # normalisation carries that into the step of every leaf whose gradient
    # it dominates
    kw = dict(feat_dim=8, n_offsets=4, voxel_size=0.05,
              capacity_headroom=2.0, q_scaling=0.05)
    cfg_j = jcfg.TrainConfig(model=jcfg.ModelConfig(**kw),
                             pipe=jcfg.PipelineConfig(backend="reference",
                                                      chunk_size=128))
    cfg_t = tcfg.TrainConfig(model=tcfg.ModelConfig(**kw))
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0), pts,
                                        cfg_j.model)
    p = model.params._replace(
        mlps=_trained_sigmas(model.params.mlps, cfg_j.model),
        anchor_feat=jnp.asarray(rng.normal(size=model.params.anchor_feat.shape)
                                * 0.5, jnp.float32),
        hyper_latent=jnp.asarray(rng.normal(
            size=model.params.hyper_latent.shape), jnp.float32))
    b, adam = model.buffers, joptim.init_adam(p)
    kept = np.asarray(jst.get_mask_anchor(p, b.alive))
    scales = tuple(jlev.find_divide_scale(
        np.asarray(p.anchor)[kept], voxel, np.asarray(b.bound_min),
        np.asarray(b.bound_max), 0.2, 3))
    it0 = cfg_j.opt.context_from
    step_j = jstep.make_train_step(cfg_j, W, H, 1 << 14, "context", scales,
                                   2.0, voxel)
    bg = np.zeros(3, np.float32)

    def run_j(p, b, adam, cam, it):
        cd = {k: jnp.asarray(v) for k, v in cam.as_device_dict().items()}
        gt = jnp.asarray(np.transpose(cam.image, (2, 0, 1)))
        return step_j(p, b, adam, cd, gt, jnp.asarray(bg),
                      jnp.asarray(it, jnp.float32), jnp.asarray(True),
                      jax.random.PRNGKey(it))

    for it, cam in ((it0 + 1, cams[0]), (it0 + 2, cams[1])):
        p, b, adam, _ = run_j(p, b, adam, cam, it)
    p_t = convert.params_from_numpy(_np_tree(p), cfg_t.model, "cpu")
    b_t = convert.buffers_from_numpy(_np_tree(b), "cpu")
    adam_t = convert.adam_from_numpy(_np_tree(adam), cfg_t.model, "cpu")
    it = it0 + 3
    p_j, b_j, adam_j, m_j = run_j(p, b, adam, cams[2], it)
    kc, kr = jax.random.split(jax.random.PRNGKey(it))
    n = p.anchor.shape[0]
    draws = _jax_draws(cfg_t.model, n, kc, kr)
    calls = []

    def context_draws(gen, n_, cfg, training, device=None):
        calls.append((n_, training))
        return draws

    monkeypatch.setattr(tctx, "context_draws", context_draws)
    step_t = tstep.make_train_step(cfg_t, W, H, "context", 2.0,
                                   level_scales=scales, voxel_size=voxel)
    p_t, b_t, adam_t, m_t = step_t(
        p_t, b_t, adam_t, cams[2].as_device_dict(),
        _t(np.transpose(cams[2].image, (2, 0, 1))), _t(bg), it, True)
    assert calls == [(n, True)]

    np.testing.assert_allclose(float(m_t.loss), float(m_j.loss), rtol=1e-5)
    np.testing.assert_allclose(float(m_t.bit_per_param),
                               float(m_j.bit_per_param), rtol=1e-5)
    assert float(m_t.bit_per_param) > 0
    assert int(m_t.n_visible_gauss) == int(m_j.n_visible_gauss) > 0
    mu0 = _jax_leaves(_np_tree(adam.mu), cfg_t.model)
    mu, nu = (_jax_leaves(_np_tree(m), cfg_t.model)
              for m in (adam_j.mu, adam_j.nu))
    for got, want in ((adam_t.mu, mu), (adam_t.nu, nu)):
        assert list(got) == list(want)
        for name in got:
            _assert_close_to_max(got[name].numpy(), want[name], 1e-5, name)
    lrs = toptim.group_lrs(cfg_t.opt, it, 2.0)
    got = tst.param_leaves(p_t)
    want = _jax_leaves(_np_tree(p_j), cfg_t.model)
    assert list(got) == list(want)
    for name in got:
        _assert_adam_step_close(got[name].numpy(), want[name], mu0[name],
                                mu[name], nu[name],
                                toptim.leaf_lr(name, lrs), 3, name)
    for name in tst.Buffers._fields:
        _assert_close_to_max(getattr(b_t, name).numpy(),
                             np.asarray(getattr(b_j, name)), 1e-5, name)
    before = _jax_leaves(_np_tree(p), cfg_t.model)
    after = tst.param_leaves(p_t)
    for name in ("hyper_latent", "mlps.grid.0.l1.weight",
                 "mlps.grid.1.l2.bias", "mlps.grid.2.l1.weight",
                 "prior.matrices.0", "prior.biases.4", "prior.factors.3"):
        assert np.abs(after[name].numpy() - before[name]).max() > 0, \
            f"{name} did not move"
