"""PyTorch port against the JAX reference: the decoded-scene renderer and the
image metrics on the same numpy inputs (CPU); the port's import boundary and
its refusal to drop to the CPU on its own."""

import ast
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu import config as jcfg
from contextgs_tpu import evaluation as jeval
from contextgs_tpu.compression.codec import DecodedScene as JDecodedScene
from contextgs_tpu.models.mlps import init_decoder_mlps
from contextgs_tpu.ops import ssim as jssim
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch import evaluation as teval
from contextgs_tpu_torch.models import state as tst
from contextgs_tpu_torch.ops import ssim as tssim
from contextgs_tpu_torch.scene.cameras import Camera as TCamera

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG_KW = dict(feat_dim=8, n_offsets=4)
W, H = 64, 48


def _decoded_scene(n=400, seed=0):
    """A random decoded scene, built the way scripts/fps_bench.py builds its
    100k-anchor one, at test size."""
    rng = np.random.default_rng(seed)
    mcfg = jcfg.ModelConfig(**CFG_KW)
    return JDecodedScene(
        anchor=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
        feat=rng.normal(size=(n, mcfg.feat_dim)).astype(np.float32) * 0.3,
        scaling=rng.uniform(0.01, 0.05, (n, 6)).astype(np.float32),
        offsets=rng.normal(size=(n, mcfg.n_offsets, 3)).astype(np.float32)
        * 0.3,
        masks=(rng.random((n, mcfg.n_offsets)) < 0.7).astype(np.float32),
        hyper=np.zeros((n, mcfg.feat_dim // mcfg.hyper_divisor), np.float32),
        mlps=init_decoder_mlps(jax.random.PRNGKey(0), mcfg), prior=None,
        level_scales=[], voxel_size=0.001)


def _orbit_cameras(n, image_seed=None):
    rng = np.random.default_rng(image_seed)
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        Rm = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
        image = (None if image_seed is None
                 else rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
        cams.append(TCamera(uid=i, colmap_id=i, R=Rm,
                            T=np.array([0.0, 0.0, 4.0]), fov_x=1.2,
                            fov_y=2 * math.atan(math.tan(0.6) * H / W),
                            image=image, width=W, height=H))
    return cams


def test_decoded_renderer_matches_jax():
    dec_j = _decoded_scene()
    cfg_j = jcfg.TrainConfig(model=jcfg.ModelConfig(**CFG_KW),
                             pipe=jcfg.PipelineConfig(backend="reference",
                                                      chunk_size=128))
    cfg_t = tcfg.TrainConfig(model=tcfg.ModelConfig(**CFG_KW))
    render_j = jeval.make_decoded_renderer(dec_j, cfg_j, W, H, budget=1 << 14)
    dec_t = convert.decoded_scene_from_numpy(
        jax.tree.map(np.asarray, dec_j), cfg_t.model, "cpu")
    render_t = teval.make_decoded_renderer(dec_t, cfg_t, W, H, device="cpu")
    bg = np.float32([0.0, 0.1, 0.2])
    for cam in _orbit_cameras(3):
        cd = cam.as_device_dict()
        want = np.asarray(render_j({k: jnp.asarray(v) for k, v in cd.items()},
                                   jnp.asarray(bg)))
        got = render_t(cd, bg).numpy()
        assert np.abs(want - bg[:, None, None]).max() > 0.1    # not empty
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_metrics_match_jax(rng):
    a = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.05, 0, 1)
    flat = np.full_like(a, 0.5)                  # the E[x²]−μ² clamp case
    for x, y in ((a, b), (flat, b), (a, a)):
        np.testing.assert_allclose(
            float(tssim.ssim(torch.from_numpy(x), torch.from_numpy(y))),
            float(jssim.ssim(jnp.asarray(x), jnp.asarray(y))), atol=1e-5)
    np.testing.assert_allclose(
        float(tssim.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(jssim.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    want = jeval.evaluate_images([a, flat], [b, b])
    got = teval.evaluate_images([a, flat], [b, b], device="cpu")
    np.testing.assert_allclose(got["PSNR"], want["PSNR"], rtol=1e-5)
    np.testing.assert_allclose(got["SSIM"], want["SSIM"], atol=1e-5)
    assert got["LPIPS"] is None and got["LPIPS_skipped"]


def test_render_set_and_write_results(tmp_path):
    cfg_t = tcfg.TrainConfig(model=tcfg.ModelConfig(**CFG_KW))
    dec_t = convert.decoded_scene_from_numpy(
        jax.tree.map(np.asarray, _decoded_scene(n=200)), cfg_t.model, "cpu")
    render = teval.make_decoded_renderer(dec_t, cfg_t, W, H, device="cpu")
    cams = _orbit_cameras(2, image_seed=1)
    view_ms = []
    renders, gts, fps = teval.render_set(render, cams, np.zeros(3, np.float32),
                                         out_dir=str(tmp_path / "test"),
                                         view_ms=view_ms)
    assert len(renders) == len(gts) == len(view_ms) == 2 and fps > 0
    np.testing.assert_allclose(fps, 2e3 / sum(view_ms), rtol=1e-9)
    assert renders[0].shape == gts[0].shape == (3, H, W)
    assert (tmp_path / "test" / "renders" / "00001.png").exists()
    metrics = teval.evaluate_images(renders, gts, device="cpu")
    assert np.isfinite(metrics["PSNR"]) and np.isfinite(metrics["SSIM"])
    teval.write_results(str(tmp_path), "ours_30000", metrics, fps=fps)
    res = json.loads((tmp_path / "results.json").read_text())["ours_30000"]
    assert res["LPIPS"] is None and res["PSNR"] == metrics["PSNR"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "contextgs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            for banned in ("jax", "contextgs_tpu"):
                assert not (mod == banned or mod.startswith(banned + ".")), \
                    f"{path.relative_to(REPO)} imports {mod}"


def test_entry_points_raise_without_a_card(monkeypatch):
    """No silent CPU fallback: without a card, device=None raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_t = tcfg.TrainConfig(model=tcfg.ModelConfig(**CFG_KW))
    dec_np = jax.tree.map(np.asarray, _decoded_scene(n=50))
    dec_t = convert.decoded_scene_from_numpy(dec_np, cfg_t.model, "cpu")
    img = np.zeros((3, 4, 4), np.float32)
    pts = np.random.default_rng(0).uniform(-1, 1, (50, 3))
    calls = [
        lambda: teval.make_decoded_renderer(dec_t, cfg_t, W, H),
        lambda: teval.evaluate_images([img], [img]),
        lambda: tst.init_scene_model(pts, cfg_t.model),
        lambda: convert.decoded_scene_from_numpy(dec_np, cfg_t.model),
        lambda: convert.mlps_from_numpy(dec_np.mlps, cfg_t.model),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    teval.make_decoded_renderer(dec_t, cfg_t, W, H, device="cpu")
