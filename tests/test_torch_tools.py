"""The port's tool scripts (`contextgs_tpu_torch/scripts/`) against the
JAX package's root `scripts/` on the CPU: `codec_diag` on a JAX model
directory and on the port's own, `rd_table` and `collect_results` on a
hand-made sweep tree, `sweep`'s command lines, `growth_parity` against the
JAX package's densify (single process, and on a 2-device mesh against 2
gloo ranks), and `scaling_bench` on 1 and 2 CPU ranks.

The JAX scripts are loaded from their files (`scripts/` is no package) and
run in this process, on the conftest's CPU devices."""

import importlib.util
import json
import os
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu import config as jcfg
from contextgs_tpu.models import densify as jdn, state as jst
from contextgs_tpu.parallel import sharded as jsh
from contextgs_tpu.train import optim as joptim
from contextgs_tpu.utils import checkpoint as jckpt
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.drivers import train as train_driver
from contextgs_tpu_torch.ops.rasterize import tile_kernel
from contextgs_tpu_torch.scripts import (codec_diag, collect_results,
                                         growth_parity, make_synth_scene,
                                         rd_table, scaling_bench, sweep)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = ["--iterations", "30", "--noise_from", "10", "--context_from",
            "20", "--start_stat", "2", "--update_from", "4",
            "--update_interval", "10", "--update_until", "15",
            "--n_offsets", "4", "--checkpoint_iterations", "30",
            "--force_cpu"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(module, argv, monkeypatch, capsys):
    """The JAX script's main() with `argv`; → its stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()
    return capsys.readouterr().out


# ------------------------------------------------------------ codec_diag

def _jax_model_dir(root):
    """A JAX model directory: cfg_args and chkpnt5.pkl (+ meta) of a seeded
    state, written by the JAX package."""
    cfg = jcfg.TrainConfig(model=jcfg.ModelConfig(n_offsets=4),
                           opt=jcfg.OptimizationConfig(iterations=5))
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.5, 0.5, (400, 3))
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0), pts,
                                        cfg.model)

    def draw(x, s=0.5):
        return jnp.asarray(np.asarray(x) + rng.normal(size=x.shape) * s,
                           jnp.float32)

    p = model.params
    p = p._replace(anchor_feat=draw(p.anchor_feat, 2.0),
                   offsets=draw(p.offsets, 0.02),
                   mask_logit=draw(p.mask_logit),
                   mlps=jax.tree.map(lambda x: draw(x, 0.05), p.mlps))
    root.mkdir()
    (root / "cfg_args").write_text(cfg.to_json())
    jckpt.save_pytree(str(root / "chkpnt5.pkl"),
                      dict(params=p, buffers=model.buffers,
                           adam=joptim.init_adam(p)))
    with open(root / "chkpnt5.meta.pkl", "wb") as f:
        pickle.dump(dict(iteration=5, voxel_size=voxel,
                         level_scales=[4.37, 15.73],
                         spatial_lr_scale=1.0,
                         rng_state=np.random.default_rng(0)
                         .bit_generator.state, cam_order=[]), f)


def _table(out):
    """codec_diag's table: {stream: (n_sym, five MB columns, act/ideal,
    esc%, windows)}."""
    rows = {}
    for line in out.splitlines()[1:]:
        m = re.match(r"\s*(\w+)\s+(\d+)((?:\s+[0-9.]+){7})\s+(\[.*\])$",
                     line)
        if m:
            rows[m.group(1)] = (int(m.group(2)),
                                [float(x) for x in m.group(3).split()],
                                m.group(4))
    return rows


def test_codec_diag_matches_jax_on_a_jax_model(tmp_path, monkeypatch,
                                               capsys):
    """Both packages' codec_diag on the same JAX model directory: the same
    streams, symbols, escapes and windows; each bit column within 1% (the
    two predictors differ in the last bits, as the codec test's streams
    do); the JSON parses."""
    model = tmp_path / "jax_model"
    _jax_model_dir(model)
    want = _run_jax(_jax_script("codec_diag"),
                    ["-m", str(model), "--out", str(tmp_path / "j.json")],
                    monkeypatch, capsys)
    assert codec_diag.main(["-m", str(model), "--out",
                            str(tmp_path / "t.json"), "--force_cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]
    rows, want_rows = _table(got), _table(want)
    assert set(rows) == set(want_rows) == {"feat", "scaling", "offsets"}
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    for name in rows:
        assert rows[name][0] == want_rows[name][0] > 0, name
        assert rows[name][2] == want_rows[name][2], name
        a, b = t["streams"][name], j["streams"][name]
        assert a["n_sym"] == b["n_sym"] and a["n_escape"] == b["n_escape"]
        assert sorted(set(a["windows"])) == sorted(set(b["windows"]))
        for k in ("ideal_bits", "win_bits", "qcdf_bits", "payload_bits",
                  "escape_bits"):
            assert abs(a[k] - b[k]) <= 0.01 * max(abs(b[k]), 1.0), (name, k)
    assert set(t["totals"]) == set(j["totals"])


def test_codec_diag_on_the_port_model(tmp_path, capsys):
    """codec_diag on a model directory of the port's train driver (its
    chkpnt30.pt): for each stream the payload and escape bits are the
    bytes of the driver's {stream}{level}.b files (the encode is
    deterministic), and the JSON parses."""
    scene, model = tmp_path / "scene", tmp_path / "model"
    assert make_synth_scene.main(["--out", str(scene), "--res", "64",
                                  "--cams", "8", "--gauss", "2000",
                                  "--points", "300", "--force_cpu"]) == 0
    assert train_driver.main(["-s", str(scene), "-m", str(model),
                              "--no_tensorboard", "--skip_render",
                              *SCHEDULE]) == 0
    capsys.readouterr()
    out = tmp_path / "diag.json"
    assert codec_diag.main(["-m", str(model), "--out", str(out),
                            "--force_cpu"]) == 0
    assert "encode totals (MB):" in capsys.readouterr().out
    report = json.loads(out.read_text())
    bits = model / "bitstreams"
    for name, s in report["streams"].items():
        files = sorted(bits.glob(f"{name}[0-9]*.b"))
        assert files and s["n_sym"] > 0, name
        assert s["payload_bits"] + s["escape_bits"] == 8 * sum(
            f.stat().st_size for f in files), name


# ------------------------------------------------- rd_table, collect_results

def _sweep_tree(root):
    """A hand-made sweep output: a relaunched λ (its partial entry first),
    a malformed entry, λ = 0.0005 read from its results.json, and the
    drivers' log lines."""
    entries = [
        dict(lmbda=0.004, iters=30000, rc=-9,
             last_progress=dict(iteration=12100)),
        dict(note="hand-written, no lambda"),
        dict(lmbda=0.004, iters=30000, rc=0, results=dict(
            ours=dict(PSNR=27.125, SSIM=0.8123, size_MB=14.5, FPS=101.0),
            ours_from_ckpt=dict(PSNR=27.13, SSIM=0.8124, size_MB=14.25,
                                FPS=99.5))),
        dict(lmbda=0.0005, iters=30000, rc=0),
        dict(lmbda=0.001, iters=30000, rc=1,
             last_progress=dict(iteration=800)),
    ]
    root.mkdir()
    (root / "summary.jsonl").write_text(
        "".join(json.dumps(e) + "\n" for e in entries) + "\n")
    run = root / "l0.0005"
    run.mkdir()
    (run / "results.json").write_text(json.dumps(dict(
        ours=dict(PSNR=28.5, SSIM=0.85, LPIPS=None, size_MB=22.75, FPS=90.0),
        decoded=dict(PSNR=28.5, SSIM=0.85, LPIPS=None, size_MB=22.75,
                     FPS=91.0))))
    (run / "outputs.log").write_text(
        "2026-01-01 INFO iter 2000 size estimate: {'feat': 1.5, "
        "'total': 23.125}\n"
        "2026-01-01 INFO training done in 812.4s\n"
        "2026-01-01 INFO encoded: 22.750 MB total (feat 1.0) in 41.2s\n"
        "2026-01-01 INFO decoded 102000 anchors in 39.9s\n")
    other = root / "nested" / "l0.004"
    other.mkdir(parents=True)
    (other / "results.json").write_text(json.dumps(dict(
        ours_from_ckpt=dict(PSNR=27.13, SSIM=0.8124, LPIPS=0.2,
                            size_MB=14.25, FPS=99.5))))


def test_rd_table_matches_jax(tmp_path, monkeypatch, capsys):
    tree = tmp_path / "sweep"
    _sweep_tree(tree)
    want = _run_jax(_jax_script("rd_table"), ["--out", str(tree)],
                    monkeypatch, capsys)
    assert rd_table.main(["--out", str(tree)]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "| 0.0005 |" in got and "| 0.004 |" in got
    assert len(got.splitlines()) == 2 + 3


def test_collect_results_matches_jax(tmp_path, monkeypatch, capsys):
    tree = tmp_path / "sweep"
    _sweep_tree(tree)
    _run_jax(_jax_script("collect_results"),
             ["--root", str(tree), "--out", str(tmp_path / "j.csv")],
             monkeypatch, capsys)
    assert collect_results.main(["--root", str(tree), "--out",
                                 str(tmp_path / "t.csv")]) == 0
    got = (tmp_path / "t.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes()
    assert got.count(b"\n") == 1 + 3
    assert collect_results.main(["--root", str(tmp_path / "none"),
                                 "--out", str(tmp_path / "x.csv")]) == 1


def test_sweep_command_lines_match_jax(tmp_path, monkeypatch, capsys):
    """The same flags give JAX's command lines with the driver replaced
    (`train.py` → `-m contextgs_tpu_torch.drivers.train`); a run that
    exits non-zero is reported and the sweep goes on."""
    argv = ["--dataset", "tandt", "--data_root", str(tmp_path / "data"),
            "--scenes", "truck", "train", "--lmbdas", "0.004", "0.0005",
            "--out", str(tmp_path / "out"), "--iterations", "600",
            "--extra", "--force_cpu", "--noise_from", "200"]

    def record(calls):
        def run(cmd, *a, **kw):
            calls.append(list(cmd))
            return type("Done", (), dict(returncode=3 if len(calls) == 2
                                         else 0))()
        return run

    want_calls, got_calls = [], []
    monkeypatch.setattr("subprocess.run", record(want_calls))
    want = _run_jax(_jax_script("sweep"), argv, monkeypatch, capsys)
    monkeypatch.setattr("subprocess.run", record(got_calls))
    assert sweep.main(argv) == 0
    got = capsys.readouterr().out
    assert len(got_calls) == len(want_calls) == 4
    for g, w in zip(got_calls, want_calls):
        i = w.index("train.py")
        assert g == w[:i] + ["-m", "contextgs_tpu_torch.drivers.train"] \
            + w[i + 1:]
    failed = [ln for ln in got.splitlines() if ln.startswith("FAILED")]
    assert failed == [ln for ln in want.splitlines()
                      if ln.startswith("FAILED")]
    assert failed == ["FAILED: truck λ=0.0005 (exit 3)"]


# ---------------------------------------------------------- growth_parity

POINTS, KEYS, DEVICES = 2000, 2, 2


def _jax_growth_state():
    """The JAX script's seeded state (scripts/growth_parity.py:42-70)."""
    mcfg = jcfg.ModelConfig(feat_dim=8, n_offsets=4, voxel_size=0.01,
                            capacity_headroom=4.0)
    ocfg = jcfg.OptimizationConfig(update_interval=100,
                                   success_threshold=0.8,
                                   densify_grad_threshold=0.0002)
    cfg = jcfg.TrainConfig(model=mcfg, opt=ocfg,
                           pipe=jcfg.PipelineConfig(), source_path="",
                           model_path="")
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 1, (POINTS, 3)).astype(np.float32)
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0), pts, mcfg)
    p, b = model.params, model.buffers
    n, k = b.offset_grad_accum.shape
    g = (rng.random((n, k)) < 0.2) * rng.lognormal(-7.5, 1.0, (n, k))
    p = p._replace(offsets=jnp.asarray(
        rng.normal(0, 2.0, (n, k, 3)).astype(np.float32)))
    alive = np.asarray(b.alive)
    b = b._replace(
        offset_grad_accum=jnp.asarray(
            np.where(alive[:, None], g * 100.0, 0.0).astype(np.float32)),
        offset_denom=jnp.asarray(
            np.where(alive[:, None], np.full((n, k), 100.0), 0.0)
            .astype(np.float32)),
        opacity_accum=jnp.asarray(np.where(alive, 100.0, 0.0)
                                  .astype(np.float32)),
        anchor_denom=jnp.asarray(np.where(alive, 100.0, 0.0)
                                 .astype(np.float32)))
    return cfg, p, b, joptim.init_adam(p), voxel


@pytest.fixture(scope="module")
def growth():
    """The JAX side of growth_parity: its state, per key the JAX single
    call's result and draws, and the 2-device mesh's columns with each
    shard's draws."""
    cfg, p, b, adam, voxel = _jax_growth_state()
    n, k = b.offset_grad_accum.shape
    n0 = int(np.asarray(b.alive).sum())
    mesh = jsh.make_mesh(DEVICES)
    dens = jsh.make_sharded_densify(cfg, mesh, voxel)
    hp, hb, ha, _ = jsh.reshard_anchors(
        jax.device_get(p), jax.device_get(b), jax.device_get(adam), DEVICES,
        voxel)
    n_local = hb.alive.shape[0] // DEVICES * k
    keys = []
    for ki in range(KEYS):
        key = jax.random.PRNGKey(1000 + ki)
        r1 = jax.jit(lambda p_, b_, a_, k_: jdn.adjust_anchors(
            p_, b_, a_, cfg.model, cfg.opt, voxel, k_))(p, b, adam, key)
        single_draws = torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(kk, (n * k,)))
            for kk in jax.random.split(key, cfg.model.update_depth)]))
        sp, sb, sa, _ = jsh.shard_model(mesh, hp, hb, ha)
        sp, sb, sa, _, _, ovf = dens(sp, sb, sa, key)
        _, hb2, _, _ = jsh.reshard_anchors(
            jax.device_get(sp), jax.device_get(sb), jax.device_get(sa),
            DEVICES, voxel)
        shard_draws = [torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(kk, (n_local,)))
            for kk in jax.random.split(jax.random.fold_in(key, r),
                                       cfg.model.update_depth)]))
            for r in range(DEVICES)]
        keys.append(dict(
            single=int(np.asarray(r1.buffers.alive).sum()) - n0,
            single_overflowed=bool(r1.overflowed), draws=single_draws,
            mesh_raw=int(np.asarray(sb.alive).sum()) - n0,
            mesh_dedup=int(np.asarray(hb2.alive).sum()) - n0,
            mesh_overflowed=bool(ovf), shard_draws=shard_draws))
    return (p, b, adam, voxel), keys


def _port_growth_state(jax_state):
    p, b, adam, voxel = jax_state
    cfg = growth_parity.config()

    def np_tree(x):
        return jax.tree.map(np.asarray, x)

    return cfg, (convert.params_from_numpy(np_tree(p), cfg.model, "cpu"),
                 convert.buffers_from_numpy(np_tree(b), "cpu"),
                 convert.adam_from_numpy(np_tree(adam), cfg.model, "cpu"),
                 voxel)


def test_growth_parity_state_is_the_jax_scripts(growth):
    """The port's seeded state is the JAX script's: the anchors, offsets,
    statistics and alive mask equal (the MLPs come from each framework's
    generator, and densify does not read them)."""
    cfg, (tp, tb, _, voxel) = _port_growth_state(growth[0])
    p, b, a, v = growth_parity.seeded_state(cfg, POINTS)
    assert v == voxel
    for name in ("anchor", "offsets", "scaling_log", "mask_logit"):
        assert torch.equal(getattr(p, name), getattr(tp, name)), name
    for name in ("alive", "offset_grad_accum", "offset_denom",
                 "opacity_accum", "anchor_denom", "bound_min", "bound_max"):
        assert torch.equal(getattr(b, name), getattr(tb, name)), name


def test_growth_parity_single_column_matches_jax(growth, monkeypatch,
                                                 capsys):
    """`growth_parity --force_cpu --devices 2 --points 2000 --keys 2` with
    each key's draws those of JAX's `adjust_anchors(key)`: its `single`
    column equals JAX's count, exactly; the table has JAX's format."""
    jax_state, keys = growth
    monkeypatch.setattr(growth_parity, "key_draws",
                        lambda cfg, nk, n: [k["draws"] for k in keys])
    assert growth_parity.main(["--force_cpu", "--devices", str(DEVICES),
                               "--points", str(POINTS), "--keys",
                               str(KEYS)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["key", "single", "mesh_raw", "mesh_dedup",
                                "delta%"]
    rows = [ln.split() for ln in lines[1:1 + KEYS]]
    assert [int(r[1]) for r in rows] == [k["single"] for k in keys]
    assert all(k["single"] > 0 and not k["single_overflowed"] for k in keys)
    assert re.match(r"mean delta [-+]\d+\.\d%  \(n0=\d+, 2 devices\)$",
                    lines[1 + KEYS])


def test_growth_parity_mesh_columns_match_jax(growth):
    """The sharded densify on 2 gloo ranks, each handed the draws of its
    JAX shard (`fold_in(key, shard)`): mesh_raw and mesh_dedup equal the
    JAX mesh's on 2 devices, exactly, with no overflow."""
    jax_state, keys = growth
    cfg, state = _port_growth_state(jax_state)
    got = growth_parity.mesh_growth(
        cfg, state, [k["draws"] for k in keys], DEVICES, "cpu",
        per_rank=[k["shard_draws"] for k in keys])
    for row, k in zip(got, keys):
        assert not row["overflowed"] and not k["mesh_overflowed"]
        assert (row["mesh_raw"], row["mesh_dedup"]) == (k["mesh_raw"],
                                                        k["mesh_dedup"])
        assert row["mesh_raw"] >= row["mesh_dedup"] > 0


# ---------------------------------------------------------- scaling_bench

def test_scaling_bench_on_cpu_ranks(capsys):
    """`scaling_bench --force_cpu 1,2 --size 32 --points 300 --iters 2`:
    one line per world size in the JAX script's format, a finite loss;
    `--budget` is refused."""
    assert scaling_bench.main(["--force_cpu", "1,2", "--size", "32",
                               "--points", "300", "--iters", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for n, line in zip((1, 2), lines):
        m = re.match(rf"devices={n}: +([0-9.]+) kpix/s \(.*ratios not "
                     r"meaningful\) loss=(\S+)$", line)
        assert m, line
        assert float(m.group(1)) > 0 and np.isfinite(float(m.group(2)))
    with pytest.raises(SystemExit):
        scaling_bench.main(["--budget", "8192"])
    assert "refused" in capsys.readouterr().err


def test_scaling_bench_keeps_each_band_kernel_args():
    """`measure(..., keep_kernel_args=True)` on 2 CPU ranks at 32x32: each
    rank hands back its last step's K1 and K2 arguments, for its own band
    (tile row offsets 0 and 1, 16 rows each) of one set of splat rows, and
    K2's forward outputs are K1's on those arguments."""
    res = scaling_bench.measure(2, 32, 300, 1, device="cpu",
                                keep_kernel_args=True)
    kept = [r["kernel_args"] for r in res["ranks"]]
    for rank, args in enumerate(kept):
        k1, k2 = args["blend_forward"], args["blend_backward"]
        assert len(k1) == 7 and len(k2) == 12
        assert k1[3:] == (32, 16, k1[5], rank) and k2[8:] == k1[3:]
        for a, b in zip(k1[:3], k2[:3]):
            assert torch.equal(a, b)
        for got, want in zip(k2[3:6], tile_kernel.blend_forward(*k1)):
            assert torch.equal(got, want)
        assert k2[6].shape == (3, 16, 32) and k2[7].shape == (16, 32)
    assert torch.equal(kept[0]["blend_forward"][0],
                       kept[1]["blend_forward"][0])
