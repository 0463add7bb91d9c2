"""PyTorch port against the JAX reference in LPIPS (CPU): the VGG16
features and linear heads on the same converted random weights, the
weights file that gates the metric, and the metric in evaluate_images."""

import jax
import numpy as np
import pytest
import torch

from contextgs_tpu import evaluation as jeval
from contextgs_tpu.ops import lpips as jlpips
from contextgs_tpu_torch import evaluation as teval
from contextgs_tpu_torch.ops import lpips as tlpips

torch.set_num_threads(1)

ENV = "CONTEXTGS_LPIPS_WEIGHTS"


def _jax_weights_file(path):
    """JAX random weights written with the keys of the JAX package's
    export_weights_from_torch."""
    w = jlpips.random_weights(jax.random.PRNGKey(3))
    arrs = {}
    for i, (k, b) in enumerate(w.convs):
        arrs[f"conv{i}_w"] = np.asarray(k)
        arrs[f"conv{i}_b"] = np.asarray(b) + 0.01 * i
    for j, lin in enumerate(w.lins):
        arrs[f"lin{j}"] = np.asarray(lin)
    np.savez(path, **arrs)
    return path


def _save_weights(path, w):
    """Write port weights with the keys `load_weights` reads."""
    arrs = {}
    for i, (wgt, b) in enumerate(w.convs):
        arrs[f"conv{i}_w"] = wgt.numpy().transpose(2, 3, 1, 0)
        arrs[f"conv{i}_b"] = b.numpy()
    for j, lin in enumerate(w.lins):
        arrs[f"lin{j}"] = lin.numpy()
    np.savez(path, **arrs)


def _images(seed, n=2, size=64):
    rng = np.random.default_rng(seed)
    return [rng.random((3, size, size)).astype(np.float32) for _ in range(n)]


def test_lpips_matches_jax(tmp_path):
    path = _jax_weights_file(str(tmp_path / "w.npz"))
    jw, tw = jlpips.load_weights(path), tlpips.load_weights(path)
    assert len(tw.convs) == 13 and len(tw.lins) == 5
    for (a, b) in zip(_images(0), _images(1)):
        want = float(jlpips.lpips(jw, jax.numpy.asarray(a),
                                  jax.numpy.asarray(b)))
        got = float(tlpips.lpips(tw, torch.from_numpy(a),
                                 torch.from_numpy(b)))
        assert want > 0
        assert got == pytest.approx(want, rel=1e-5)
    same = torch.from_numpy(_images(2, n=1)[0])
    assert float(tlpips.lpips(tw, same, same)) == 0.0


def test_load_weights_gated(tmp_path, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert tlpips.load_weights() is None
    monkeypatch.setenv(ENV, str(tmp_path / "missing.npz"))
    assert tlpips.load_weights() is None
    monkeypatch.setenv(ENV, _jax_weights_file(str(tmp_path / "w.npz")))
    assert tlpips.load_weights() is not None


def test_weights_npz_round_trip(tmp_path):
    """random_weights → the weights file → load_weights gives the same tensors;
    the JAX package reads the file into the same values, [kh,kw,cin,cout]."""
    w = tlpips.random_weights(torch.Generator().manual_seed(5))
    path = str(tmp_path / "port.npz")
    _save_weights(path, w)
    back = tlpips.load_weights(path)
    for (a, b), (c, d) in zip(w.convs, back.convs):
        assert torch.equal(a, c) and torch.equal(b, d)
    for a, c in zip(w.lins, back.lins):
        assert torch.equal(a, c)
    jw = jlpips.load_weights(path)
    for (a, _), (c, _) in zip(w.convs, jw.convs):
        np.testing.assert_array_equal(a.numpy().transpose(2, 3, 1, 0),
                                      np.asarray(c))


def test_evaluate_images_lpips_matches_jax(tmp_path, monkeypatch):
    """Without weights LPIPS is None and LPIPS_skipped reads as JAX's; with
    a weights file both packages report the same LPIPS."""
    renders, gts = _images(3), _images(4)
    monkeypatch.delenv(ENV, raising=False)
    got, want = (teval.evaluate_images(renders, gts, device="cpu"),
                 jeval.evaluate_images(renders, gts))
    assert got["LPIPS"] is None and want["LPIPS"] is None
    assert got["LPIPS_skipped"] == want["LPIPS_skipped"]
    monkeypatch.setenv(ENV, _jax_weights_file(str(tmp_path / "w.npz")))
    got, want = (teval.evaluate_images(renders, gts, device="cpu"),
                 jeval.evaluate_images(renders, gts))
    assert "LPIPS_skipped" not in got and "LPIPS_skipped" not in want
    assert got["LPIPS"] == pytest.approx(want["LPIPS"], rel=1e-5)
    np.testing.assert_allclose(got["per_view"]["LPIPS"],
                               want["per_view"]["LPIPS"], rtol=1e-5)
