"""PyTorch port against the JAX reference in the codec (CPU): the range coder
and its CDF quantizer, the window functions and stream coding, `mlp.pkl`,
and encode_scene / decode_scene on a small seeded model, down to the decoded
scene's renders and results.json.

Finding held here: the two packages' predictors give float32 μ, σ and Q that
differ in the last bits (XLA's and torch's matmuls and tanh round apart),
and one CDF row that differs by a unit derails a range decoder. So each
package decodes the other's files exactly when it is handed the other's μ,
σ and Q, and on its own only where they agree to the bit."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

from contextgs_tpu import config as jcfg
from contextgs_tpu import evaluation as jeval
from contextgs_tpu.compression import codec as jcodec
from contextgs_tpu.compression import coder as jcoder
from contextgs_tpu.models import levels as jlev
from contextgs_tpu.models import state as jst
from contextgs_tpu.utils import checkpoint as jckpt
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch import evaluation as teval
from contextgs_tpu_torch.compression import codec as tcodec
from contextgs_tpu_torch.compression import coder as tcoder
from contextgs_tpu_torch.models import levels as tlev
from contextgs_tpu_torch.models import state as tst
from contextgs_tpu_torch.utils import checkpoint as tckpt
from test_torch_eval import W, H, _orbit_cameras

torch.set_num_threads(1)

CFG_KW = dict(feat_dim=8, n_offsets=4, hyper_divisor=4, level_num=3,
              voxel_size=0.05)
SCALES = [4.0, 16.0]
FIELDS = ("anchor", "feat", "scaling", "offsets", "masks", "hyper")


# ------------------------------------------------------------- coder

def _gaussian_cdf_rows(means, scales, lo, hi):
    """Float CDF rows over symbols lo..hi for per-element gaussians
    (tests/test_coder.py's rows)."""
    x = (np.arange(lo, hi + 2) - 0.5)[None, :]
    c = norm.cdf(x, means[:, None], np.maximum(scales[:, None], 1e-9))
    c = (c - c[:, :1]) / np.maximum(c[:, -1:] - c[:, :1], 1e-12)
    return np.clip(c, 0.0, 1.0)


def _coder_case(case):
    """(float CDF rows [N, S+1] or one shared row [S+1], symbols)."""
    rng = np.random.default_rng(11)
    n = 3000
    if case == "gaussian":
        means = rng.normal(size=n) * 3
        scales = 0.5 + rng.random(n) * 2
        vals = np.round(rng.normal(size=n) * 2 + means).astype(np.int64)
        lo, hi = int(vals.min()) - 2, int(vals.max()) + 2
        return (_gaussian_cdf_rows(means, scales, lo, hi),
                (vals - lo).astype(np.int32))
    if case == "extreme":
        # nearly degenerate rows (one dominant symbol), every symbol coded
        rows = _gaussian_cdf_rows(np.zeros(n), np.full(n, 1e-6), -5, 5)
        return rows, rng.integers(0, 11, n).astype(np.int32)
    if case == "flat_runs":
        # rows with long flat runs and a jump to 1 (bins the ≥1 floor widens)
        rows = np.sort(rng.random((n, 40)), axis=1)
        rows[:, 10:30] = rows[:, 10:11]
        rows[:, 0], rows[:, -1] = 0.0, 1.0
        return rows, rng.integers(0, 39, n).astype(np.int32)
    if case == "bernoulli":
        return (np.array([0.0, 1 - 0.83, 1.0]),
                (rng.random(20000) < 0.83).astype(np.int32))
    assert case == "shared_wide"
    pmf = np.exp(-0.5 * (np.arange(-40, 41) / 6.0) ** 2)
    cdf = np.concatenate([[0.0], np.cumsum(pmf)]) / pmf.sum()
    return cdf, rng.integers(0, 81, n).astype(np.int32)


@pytest.mark.parametrize("case", ["gaussian", "extreme", "flat_runs",
                                  "bernoulli", "shared_wide"])
def test_coder_matches_jax(case):
    """quantize_cdf exact, the coded bytes identical (the same C++ source)
    and the port's decode exact, per-symbol rows and one shared row."""
    rows_f, syms = _coder_case(case)
    want = jcoder.quantize_cdf(rows_f)
    got = tcoder.quantize_cdf(rows_f)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    if rows_f.ndim == 1:
        data = tcoder.encode_shared(got, syms)
        assert data == jcoder.encode_shared(want, syms)
        np.testing.assert_array_equal(
            tcoder.decode_shared(got, syms.size, data), syms)
    else:
        data = tcoder.encode(got, syms)
        assert data == jcoder.encode(want, syms)
        np.testing.assert_array_equal(tcoder.decode(got, data), syms)


def test_coder_empty_and_invalid():
    rows = np.zeros((0, 5), np.uint16)
    assert tcoder.encode(rows, np.zeros(0, np.int32)) == b""
    assert tcoder.decode(rows, b"").shape == (0,)
    assert tcoder.encode_shared(np.zeros(5, np.uint16),
                                np.zeros(0, np.int32)) == b""
    assert tcoder.decode_shared(np.zeros(5, np.uint16), 0, b"").shape == (0,)
    row = tcoder.quantize_cdf(np.linspace(0, 1, 5))
    with pytest.raises(ValueError, match="invalid symbol"):
        tcoder.encode_shared(row, np.array([4], np.int32))
    with pytest.raises(ValueError, match="symbols for"):
        tcoder.encode(row[None], np.zeros(2, np.int32))


# ------------------------------------------------- windows and streams

def _stream(kind, n=700):
    """(x, mean, scale, q) float32 of one flat stream."""
    r = np.random.default_rng({"normal": 1, "outliers": 3, "wide": 4,
                               "int32_escapes": 5}[kind])
    q = (0.01 * (1 + r.random(n))).astype(np.float32)
    mean = (r.normal(0, 1, n) * 0.05).astype(np.float32)
    scale = (0.02 * (0.5 + r.random(n))).astype(np.float32)
    x = mean + r.normal(0, 0.02, n).astype(np.float32)
    if kind == "outliers":          # residuals ≈ 1e4 steps ≫ MAX_WINDOW
        x[::50], x[25::50] = 100.0, -80.0
    elif kind == "wide":            # a spread that picks a window over 128
        x = mean + r.normal(0, 1.2, n).astype(np.float32)
        scale = np.full(n, 1.0, np.float32)
    elif kind == "int32_escapes":   # a mean diverged past ±32768 steps
        mean[::70] = -20000 * q[::70]
        x[::70] = 14000 * q[::70]
    return x.astype(np.float32), mean, scale, q


@pytest.mark.parametrize("kind", ["normal", "outliers", "wide",
                                  "int32_escapes"])
def test_stream_coding_matches_jax(kind):
    """_choose_window, _window_base, _windowed_cdf_rows, _code_stream and
    _decode_stream give the reference's results exactly, and each package's
    decoder reads the other's stream."""
    x, mean, scale, q = _stream(kind)
    s = np.round(np.clip(x, -15000 * q, 15000 * q).astype(np.float64) / q)
    res = np.abs(s - np.round(mean.astype(np.float64) / q))
    assert tcodec._choose_window(res) == jcodec._choose_window(res)
    for w in (64, 256):
        base = tcodec._window_base(mean, q, w)
        np.testing.assert_array_equal(base, jcodec._window_base(mean, q, w))
        np.testing.assert_array_equal(
            tcodec._windowed_cdf_rows(mean, scale, q, base, w),
            jcodec._windowed_cdf_rows(mean, scale, q, base, w))
    got, want = tcodec._code_stream(x, mean, scale, q), \
        jcodec._code_stream(x, mean, scale, q)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    data, w, side, deq = got
    if kind in ("outliers", "int32_escapes"):
        assert len(side) > 0
    if kind == "wide":
        assert w > 128
    if kind == "int32_escapes":
        rel = s - tcodec._window_base(mean, q, w)
        assert len(side) == 4 * np.sum((rel <= 0) | (rel >= w - 1))
    np.testing.assert_array_equal(
        tcodec._decode_stream(data, side, mean, scale, q, w), deq)
    np.testing.assert_array_equal(
        jcodec._decode_stream(data, side, mean, scale, q, w), deq)
    expected = (np.round(np.clip(x, -15000 * q, 15000 * q).astype(np.float64)
                         / q) * q).astype(np.float32)
    np.testing.assert_allclose(deq, expected, atol=1e-6)


def test_cdf_rows_on_cuda_without_a_card_raise(monkeypatch):
    """`_cdf_rows` asked for a CUDA device launches the kernel or raises: on
    a machine without a card it raises, and neither the plain version runs
    nor a launch is counted. On the default device it is the plain version,
    with no launch."""
    from contextgs_tpu_torch.compression import cdf_rows as tcdf

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernel's tests cover it")
    x, mean, scale, q = _stream("normal")
    base = tcodec._window_base(mean, q, 64)
    before = tcdf.launches
    want = tcodec._cdf_rows(mean, scale, q, base, 64, float_rows=True)
    np.testing.assert_array_equal(
        want[0], jcodec._windowed_cdf_rows(mean, scale, q, base, 64))
    np.testing.assert_array_equal(want[1], jcoder.quantize_cdf(want[0]))

    def plain(*args, **kw):
        raise AssertionError("the plain version ran for a CUDA device")

    monkeypatch.setattr(tcodec, "_windowed_cdf_rows", plain)
    monkeypatch.setattr(tcoder, "quantize_cdf", plain)
    with pytest.raises(RuntimeError):
        tcodec._cdf_rows(mean, scale, q, base, 64, torch.device("cuda"))
    with pytest.raises(RuntimeError):
        tcodec._decode_stream(b"", b"", mean, scale, q, 64, "cuda")
    assert tcdf.launches == before


def test_stream_stats_match_jax():
    x, mean, scale, q = _stream("outliers")
    got, want = {}, {}
    tcodec._code_stream(x, mean, scale, q, stats=got)
    jcodec._code_stream(x, mean, scale, q, stats=want)
    for k in ("cdf_s", "coder_s"):
        assert got.pop(k) >= 0 and want.pop(k) >= 0
    assert got == want


# ----------------------------------------------------------- mlp.pkl

def test_mlp_pkl_matches_jax(tmp_path):
    """The port writes the reference's mlp.pkl (leaves in its order, the
    same treedef string, so the same bytes) and reads it back; each package
    reads the other's file into the same leaves."""
    from contextgs_tpu.models.entropy import init_factorized_prior
    from contextgs_tpu.models.mlps import init_decoder_mlps

    cj, ct = jcfg.ModelConfig(**CFG_KW), tcfg.ModelConfig(**CFG_KW)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32),
        dict(mlps=init_decoder_mlps(jax.random.PRNGKey(1), cj),
             prior=init_factorized_prior(jax.random.PRNGKey(2),
                                         cj.hyper_dim)))
    jckpt.save_pytree(str(tmp_path / "jax.pkl"), tree)
    mlps, prior = tckpt.load_pytree(str(tmp_path / "jax.pkl"), ct, "cpu")
    want = [np.asarray(x) for x in jax.tree.leaves(tree)]
    got = tst.net_leaves(mlps, prior)
    assert len(got) == len(want) == 38
    for (name, x), w in zip(got.items(), want):
        np.testing.assert_array_equal(
            x.numpy().T if name.endswith(".weight") else x.numpy(), w)
    tckpt.save_pytree(str(tmp_path / "port.pkl"), mlps, prior)
    assert ((tmp_path / "port.pkl").read_bytes()
            == (tmp_path / "jax.pkl").read_bytes())
    back = jckpt.load_pytree(str(tmp_path / "port.pkl"), tree)
    for a, b in zip(jax.tree.leaves(back), want):
        np.testing.assert_array_equal(np.asarray(a), b)


# ------------------------------------------------------- encode_scene

def _seeded_model():
    """A reference model with non-trivial content (as if partly trained),
    from numpy draws: a few masks off."""
    rng = np.random.default_rng(7)
    cfg = jcfg.ModelConfig(**CFG_KW)
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0),
                                        rng.uniform(-1, 1, (300, 3)), cfg)
    p = model.params

    def draw(shape, s):
        return jnp.asarray(rng.normal(size=shape) * s, jnp.float32)

    p = p._replace(
        anchor_feat=draw(p.anchor_feat.shape, 2.0),
        hyper_latent=draw(p.hyper_latent.shape, 2.0),
        offsets=draw(p.offsets.shape, 0.3),
        mask_logit=jnp.asarray(np.where(rng.random(p.mask_logit.shape)
                                        < 0.15, -8.0, 1.0), jnp.float32))
    return p, model.buffers, voxel


def _recording(module, log):
    """Wrap module._ep_host so that every level's host μ, σ and Q are
    appended to `log` (coarsest level first)."""
    original = module._ep_host

    def record(ep, idx):
        out = original(ep, idx)
        log.append(out)
        return out
    return record


def _replaying(eph_list):
    """An _ep_host that returns the given levels' μ, σ and Q in turn."""
    it = iter(eph_list)
    return lambda ep, idx: next(it)


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """The same model encoded by both packages, with each level's host
    μ, σ and Q."""
    p, b, voxel = _seeded_model()
    ct = tcfg.ModelConfig(**CFG_KW)
    pn, bn = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, b)
    pt = convert.params_from_numpy(pn, ct, "cpu")
    bt = convert.buffers_from_numpy(bn, "cpu")
    root = tmp_path_factory.mktemp("codec")
    out = dict(voxel=voxel, pt=pt, bt=bt, jdir=str(root / "jax"),
               tdir=str(root / "port"), jeph=[], teph=[])
    mp = pytest.MonkeyPatch()
    mp.setattr(jcodec, "_ep_host", _recording(jcodec, out["jeph"]))
    mp.setattr(tcodec, "_ep_host", _recording(tcodec, out["teph"]))
    try:
        out["jbits"], out["jstates"] = jcodec.encode_scene(
            p, b, jcfg.ModelConfig(**CFG_KW), SCALES, voxel, out["jdir"],
            return_states=True)
        out["tbits"], out["tstates"] = tcodec.encode_scene(
            pt, bt, ct, SCALES, voxel, out["tdir"], return_states=True)
    finally:
        mp.undo()
    return out


def test_entropy_params_match_jax(encoded):
    """Each level's μ, σ and Q on the host lie within 1e-6 of JAX's."""
    assert len(encoded["teph"]) == len(encoded["jeph"]) == 3
    for level, (got, want) in enumerate(zip(encoded["teph"],
                                            encoded["jeph"])):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == np.float32, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"level {2 - level} {k}")


def test_port_round_trip_exact(encoded):
    ct = tcfg.ModelConfig(**CFG_KW)
    dec = tcodec.decode_scene(encoded["tdir"], ct, device="cpu")
    states = encoded["tstates"]
    for k in FIELDS + ("level",):
        np.testing.assert_array_equal(getattr(dec, k).numpy(), states[k],
                                      err_msg=k)
    # masked-out offsets decode to zero (ref gaussian_model.py:1471-1475)
    dead = dec.masks.numpy().reshape(-1) == 0
    assert dead.any() and np.all(dec.offsets.numpy().reshape(-1, 3)[dead]
                                 == 0)
    for a, b in zip(tst.net_leaves(dec.mlps, dec.prior).values(),
                    tst.net_leaves(encoded["pt"].mlps,
                                   encoded["pt"].prior).values()):
        assert torch.equal(a, b)
    # the quantized features lie within Q/2 of the kept originals
    kept = tst.get_mask_anchor(encoded["pt"], encoded["bt"].alive)
    assert (dec.feat - encoded["pt"].anchor_feat[kept]).abs().max() < 1.01


def test_files_match_jax(encoded):
    """anchor.npy and masks.b byte-identical to JAX's; every stream's size
    within 1% of JAX's; the same file set and the same bit breakdown keys."""
    jdir, tdir = encoded["jdir"], encoded["tdir"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("anchor.npy", "masks.b"):
        with open(os.path.join(jdir, name), "rb") as fj, \
                open(os.path.join(tdir, name), "rb") as ft:
            assert ft.read() == fj.read(), name
    for name in os.listdir(jdir):
        if name.endswith(".b"):
            sj = os.path.getsize(os.path.join(jdir, name))
            st = os.path.getsize(os.path.join(tdir, name))
            assert abs(st - sj) <= 0.01 * sj, (name, st, sj)
    jbits, tbits = encoded["jbits"], encoded["tbits"]
    assert tbits.keys() == jbits.keys()
    for k in ("anchor", "masks", "mlp"):
        assert tbits[k] == jbits[k], k
    assert all(isinstance(v, (int, float)) for v in tbits.values())


def test_cross_decode(encoded):
    """Each package decodes the other's files: exactly when handed the
    other's μ, σ and Q; on its own only if the two predictors agree to the
    bit, which they do not here (the finding above)."""
    ct, cj = tcfg.ModelConfig(**CFG_KW), jcfg.ModelConfig(**CFG_KW)
    jeph, teph = encoded["jeph"], encoded["teph"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcodec, "_ep_host", _replaying(jeph))
        dec_t = tcodec.decode_scene(encoded["jdir"], ct, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcodec, "_ep_host", _replaying(teph))
        dec_j = jcodec.decode_scene(encoded["tdir"], cj)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(dec_t, k).numpy(),
                                      encoded["jstates"][k], err_msg=k)
        np.testing.assert_array_equal(getattr(dec_j, k),
                                      encoded["tstates"][k], err_msg=k)
    np.testing.assert_array_equal(dec_t.level.numpy(),
                                  encoded["jstates"]["level"])
    agree = all(np.array_equal(a[k], b[k]) for a, b in zip(jeph, teph)
                for k in a)
    try:
        own = tcodec.decode_scene(encoded["jdir"], ct, device="cpu")
        exact = all(np.array_equal(getattr(own, k).numpy(),
                                   encoded["jstates"][k]) for k in FIELDS)
    except ValueError:
        exact = False
    assert exact or not agree


def test_decoded_render_matches_jax(encoded):
    """JAX's bitstream decoded and rendered by JAX against the same
    bitstream decoded (handed JAX's μ, σ and Q) and rendered by the port."""
    ct, cj = tcfg.ModelConfig(**CFG_KW), jcfg.ModelConfig(**CFG_KW)
    dec_j = jcodec.decode_scene(encoded["jdir"], cj)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcodec, "_ep_host", _replaying(encoded["jeph"]))
        dec_t = tcodec.decode_scene(encoded["jdir"], ct, device="cpu")
    render_j = jeval.make_decoded_renderer(
        dec_j, jcfg.TrainConfig(model=cj, pipe=jcfg.PipelineConfig(
            backend="reference", chunk_size=128)), W, H, budget=1 << 14)
    render_t = teval.make_decoded_renderer(
        dec_t, tcfg.TrainConfig(model=ct), W, H, device="cpu")
    bg = np.float32([0.0, 0.1, 0.2])
    for cam in _orbit_cameras(2):
        cd = cam.as_device_dict()
        want = np.asarray(render_j({k: jnp.asarray(v) for k, v in cd.items()},
                                   jnp.asarray(bg)))
        got = render_t(cd, bg).numpy()
        assert np.abs(want - bg[:, None, None]).max() > 0.1    # not empty
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_codec_chain(encoded, tmp_path):
    """The slice's path on the CPU: encode (again, byte-identical files) →
    decode → make_decoded_renderer → render_set → evaluate_images →
    write_results with the encoder's bits."""
    ct = tcfg.ModelConfig(**CFG_KW)
    out = str(tmp_path / "again")
    bits = tcodec.encode_scene(encoded["pt"], encoded["bt"], ct, SCALES,
                               encoded["voxel"], out)
    for name in os.listdir(encoded["tdir"]):
        with open(os.path.join(out, name), "rb") as fa, \
                open(os.path.join(encoded["tdir"], name), "rb") as fb:
            assert fa.read() == fb.read(), name
    dec = tcodec.decode_scene(out, ct, device="cpu")
    render = teval.make_decoded_renderer(dec, tcfg.TrainConfig(model=ct), W,
                                         H, device="cpu")
    renders, gts, fps = teval.render_set(render, _orbit_cameras(2, 3),
                                         np.zeros(3, np.float32))
    metrics = teval.evaluate_images(renders, gts, device="cpu")
    teval.write_results(str(tmp_path), "ours", metrics, size_bits=bits,
                        fps=fps)
    res = json.loads((tmp_path / "results.json").read_text())["ours"]
    assert res["size_MB"] == bits["total"] / 8 / 1024 / 1024
    assert res["size_breakdown_bits"] == bits
    assert np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"])


def test_encode_searches_missing_level_scales(encoded, tmp_path):
    """Without level scales the encoder searches them over the kept anchors
    first, as the reference does (ref gaussian_model.py:1042)."""
    ct = tcfg.ModelConfig(**CFG_KW)
    pt, bt, voxel = encoded["pt"], encoded["bt"], encoded["voxel"]
    tcodec.encode_scene(pt, bt, ct, None, voxel, str(tmp_path))
    with open(tmp_path / "meta.pkl", "rb") as f:
        got = pickle.load(f)["level_scales"]
    kept = tst.get_mask_anchor(pt, bt.alive)
    args = (pt.anchor[kept].numpy(), voxel, bt.bound_min.numpy(),
            bt.bound_max.numpy(), ct.target_ratio, ct.level_num)
    assert got == tlev.find_divide_scale(*args)
    assert got == jlev.find_divide_scale(*args)
    assert len(got) == 2
    tcodec.decode_scene(str(tmp_path), ct, device="cpu")
