"""The port's drivers from disk on the CPU (`--force_cpu`): the synthetic
scene against the JAX package's script, then train → decompress → test on
it with a 30-step, three-phase schedule, the PLY snapshot and the warm-up
reboot from it, the profiler and anomaly flags, the flags the port
refuses, the refusal to run without a card, the rasterizer bench, and a
JAX training checkpoint read without JAX.

The JAX script renders its ground truth through the Pallas kernel in
interpret mode (about a minute for 8 views), so it starts first, in a
subprocess, and is compared last."""

import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from contextgs_tpu import config as jcfg
from contextgs_tpu.models import state as jst
from contextgs_tpu.scene.colmap import read_points3d_binary
from contextgs_tpu.train import optim as joptim
from contextgs_tpu.utils import checkpoint as jckpt
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.drivers import bench, decompress
from contextgs_tpu_torch.drivers import test as test_driver
from contextgs_tpu_torch.drivers import train as train_driver
from contextgs_tpu_torch.models import state as tst
from contextgs_tpu_torch.scene import snapshot as tsnap
from contextgs_tpu_torch.scene.ply_io import read_ply
from contextgs_tpu_torch.scripts import make_synth_scene
from contextgs_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = ["--res", "64", "--cams", "8", "--gauss", "2000", "--points", "300",
         "--force_cpu"]
SCHEDULE = ["--iterations", "30", "--noise_from", "10", "--context_from",
            "20", "--start_stat", "2", "--update_from", "4",
            "--update_interval", "10", "--update_until", "15",
            "--n_offsets", "4", "--checkpoint_iterations", "30",
            "--force_cpu"]
SCENE_FILES = ("sparse/0/cameras.bin", "sparse/0/images.bin",
               "sparse/0/points3D.bin", "oracle.npz")
# run in a fresh interpreter: a driver's main, then the modules it left
# imported that the port must not need
RUN_MAIN = textwrap.dedent("""
    import json, sys, torch
    torch.set_num_threads(1)
    from contextgs_tpu_torch.drivers import {module}
    code = {module}.main({argv!r})
    print(json.dumps(dict(code=code, jax="jax" in sys.modules,
                          PIL="PIL" in sys.modules)))
""")


def _run(code, timeout=300):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """The JAX script's scene, started in the background."""
    root = tmp_path_factory.mktemp("jax_scene")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(root / "jax_cc"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_scene.py"),
         "--out", str(root / "scene"), *SCENE], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    yield proc, root / "scene"
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def scene(jax_scene, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_scene") / "scene"
    assert make_synth_scene.main(["--out", str(root), *SCENE]) == 0
    return root


@pytest.fixture(scope="module")
def trained(scene, tmp_path_factory):
    """A model directory of the train driver, run in its own interpreter;
    its bitstreams are copied aside before any other driver writes them."""
    model = tmp_path_factory.mktemp("model") / "m"
    got = _run(RUN_MAIN.format(module="train", argv=[
        "-s", str(scene), "-m", str(model), *SCHEDULE]))
    assert got == dict(code=0, jax=False, PIL=False)
    shutil.copytree(model / "bitstreams", model.parent / "bitstreams_train")
    return model


def _results(model):
    return json.loads((model / "results.json").read_text())


def test_train_writes_every_output(trained):
    ours = _results(trained)["ours"]
    for k in ("PSNR", "SSIM", "FPS", "size_MB"):
        assert np.isfinite(ours[k]) and ours[k] > 0, k
    assert ours["LPIPS"] is None and ours["LPIPS_skipped"]
    assert {p.name for p in (trained / "point_cloud" / "iteration_30")
            .iterdir()} == {"point_cloud.ply", "checkpoint.pth",
                            "checkpoint.pth.meta"}
    assert (trained / "chkpnt30.pt").exists()
    assert {"anchor.npy", "meta.pkl", "mlp.pkl", "hyper.b", "masks.b",
            "feat0.b", "offsets2.b"} <= {p.name for p in
                                         (trained / "bitstreams").iterdir()}
    cfg = tcfg.TrainConfig.from_json((trained / "cfg_args").read_text())
    assert cfg.opt.iterations == 30 and cfg.model.n_offsets == 4
    log = (trained / "outputs.log").read_text()
    assert "iter 10 densify" in log and "level scales" in log
    assert "test: PSNR" in log
    assert len(list((trained / "tb").iterdir())) == 1


def test_decompress_equals_ours(trained, scene):
    assert decompress.main(["-s", str(scene), "-m", str(trained),
                            "--force_cpu"]) == 0
    res = _results(trained)
    for k in ("PSNR", "SSIM"):
        assert res["decoded"][k] == res["ours"][k], k


def test_test_driver_reencodes_identically(trained, scene):
    assert test_driver.main(["-s", str(scene), "-m", str(trained),
                             "--force_cpu"]) == 0
    train_bits = trained.parent / "bitstreams_train"
    names = sorted(p.name for p in train_bits.iterdir())
    assert names == sorted(p.name for p in (trained / "bitstreams").iterdir())
    for name in names:
        assert ((train_bits / name).read_bytes()
                == (trained / "bitstreams" / name).read_bytes()), name
    res = _results(trained)
    for k in ("PSNR", "SSIM", "size_MB"):
        assert res["ours_from_ckpt"][k] == res["ours"][k], k


def test_snapshot_is_the_final_state(trained):
    cfg = tcfg.TrainConfig.from_json((trained / "cfg_args").read_text())
    model0, _ = tst.init_scene_model(np.zeros((4, 3)), cfg.model,
                                     generator=torch.Generator(),
                                     device="cpu")
    params, buffers, _, meta = load_checkpoint(
        str(trained / "chkpnt30.pt"), model0.params, "cpu")
    pc = trained / "point_cloud" / "iteration_30"
    snap = tsnap.load_model_ply(str(pc / "point_cloud.ply"), cfg.model,
                                tst.SceneModel(params, buffers))
    alive = buffers.alive
    n = int(alive.sum())
    assert int(snap.buffers.alive.sum()) == n
    for f in tst.ANCHOR_FIELDS:
        assert torch.equal(getattr(snap.params, f)[:n],
                           getattr(params, f)[alive]), f
    mlps, prior, extra = tsnap.load_networks(str(pc / "checkpoint.pth"),
                                             cfg.model, "cpu")
    for (name, a), b in zip(tst.net_leaves(mlps, prior).items(),
                            tst.net_leaves(params.mlps,
                                           params.prior).values()):
        assert torch.equal(a, b), name
    assert extra["iteration"] == 30
    assert extra["level_scales"] == meta["level_scales"]
    np.testing.assert_array_equal(extra["bound_min"],
                                  buffers.bound_min.numpy())


def test_warmup_profile_and_anomaly_flags(scene, tmp_path):
    """--warmup reboots a second run from the PLY snapshot's anchors;
    --profile_steps writes a torch.profiler trace and the program's spans
    of the profiled steps beside it; --detect_anomaly runs."""
    model = tmp_path / "w"
    assert train_driver.main([
        "-s", str(scene), "-m", str(model), "--iterations", "4",
        "--noise_from", "100", "--context_from", "200", "--n_offsets", "4",
        "--warmup", "--skip_codec", "--no_tensorboard", "--profile_steps",
        "2", "--detect_anomaly", "--force_cpu"]) == 0
    log = (model / "outputs.log").read_text()
    assert "rebooting from last PLY snapshot" in log
    inits = [int(line.split("init: ")[1].split()[0])
             for line in log.splitlines() if "init: " in line]
    v = read_ply(str(model / "point_cloud" / "iteration_4" /
                     "point_cloud.ply"))
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    voxel = tcfg.ModelConfig().voxel_size
    assert len(inits) == 2
    assert inits[1] == len(tst.voxelize_points(pts, voxel))
    trace = json.loads((model / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]
    # the program's spans of the two profiled steps, a step each
    spans = json.loads((model / "profile" / "spans.json").read_text())
    assert spans["root"] == "train/step" and spans["units"] == 2
    assert spans["spans"]["train/step"]["count"] == 1
    assert spans["spans"]["train/render"]["count"] == 1
    assert not torch.is_anomaly_enabled()


def test_detect_anomaly_with_mesh(scene, tmp_path):
    """`--mesh 2 --force_cpu --detect_anomaly` trains on two gloo ranks
    with anomaly mode on in each, as the JAX driver sets jax_debug_nans for
    a mesh run; this process's mode is left as it was."""
    kept = {}

    def keep(fn):
        def call(*args, **kw):
            kept["ts"] = fn(*args, **kw)
            return kept["ts"]
        return call

    with mock.patch.object(train_driver, "train_sharded",
                           keep(train_driver.train_sharded)):
        assert train_driver.main([
            "-s", str(scene), "-m", str(tmp_path / "a"), "--iterations",
            "3", "--noise_from", "100", "--context_from", "200",
            "--n_offsets", "4", "--skip_codec", "--no_tensorboard",
            "--mesh", "2", "--force_cpu", "--detect_anomaly"]) == 0
    reports = kept["ts"].ranks
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["anomaly_mode"] for r in reports)
    assert len(reports[0]["steps"]) == 3
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("main, flags, why", [
    (train_driver.main, ["--budget", "4096"], "no instance budget"),
    (train_driver.main, ["--train_vis_cap", "100"], "no visible cap"),
    (train_driver.main, ["--backend", "pallas"], "plain versions on CPU"),
    (train_driver.main, ["--mesh", "4", "--profile_steps", "2"],
     "processes of their own"),
    (train_driver.main, ["--mesh_force_cpu"], "without --mesh"),
    (train_driver.main, ["--gui"], None),
    (train_driver.main, ["--ip", "0.0.0.0"], None),
    (train_driver.main, ["--port", "6010"], None),
    (decompress.main, ["--budget", "8"], "no instance budget"),
    (test_driver.main, ["--budget", "8"], "no instance budget"),
], ids=["budget", "train_vis_cap", "backend", "mesh", "mesh_force_cpu",
        "gui", "ip", "port", "decompress_budget", "test_budget"])
def test_refused_flags(main, flags, why, capsys):
    """Each flag the port has no meaning for exits with the reason. The
    viewer's flags (`--gui`, `--ip`, `--port`) were refused until the SIBR
    viewer was ported; `why=None` holds that the driver now takes them
    (and `--detect_anomaly` with `--mesh`)."""
    if why is None:
        p = train_driver.build_parser()
        args = p.parse_args(["-s", "nowhere", *flags, "--mesh", "2",
                             "--detect_anomaly", "--force_cpu"])
        train_driver.refuse(p, args)
        assert "refused" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as exc:
        main(["-s", "nowhere", "-m", "nowhere", *flags, "--force_cpu"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "refused" in err and why in err
    with pytest.raises(SystemExit):
        make_synth_scene.main(["--out", "nowhere", "--budget", "8",
                               "--force_cpu"])


def _shared(a, b):
    """`a` on the keys it shares with `b`, through nested dicts."""
    return {k: _shared(a[k], b[k]) if isinstance(a[k], dict) else a[k]
            for k in a.keys() & b.keys()}


@pytest.fixture(scope="module")
def jax_train_module():
    """The JAX package's root train.py, imported without its environment
    defaults leaking into this process."""
    spec = importlib.util.spec_from_file_location(
        "_jax_train_driver", os.path.join(REPO, "train.py"))
    module = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("argv", [
    [],
    ["--iterations", "600", "--noise_from", "200", "--context_from", "400",
     "--start_stat", "50", "--update_from", "100", "--update_interval",
     "100", "--update_until", "500", "--lmbda", "0.004", "--lmbda_rec",
     "0.5", "--disable_hyper", "--level_num", "2", "--seed", "3",
     "--checkpoint_iterations", "100", "600", "--test_iterations", "300",
     "600", "--start_checkpoint", "ck.pt"],
    ["--preset", "bungeenerf"],
    ["--preset", "mipnerf360", "--lod", "30"],
    ["--preset", "nerf_synthetic", "--voxel_size", "0.02"],
    ["--voxel_size", "0.01", "--white_background", "-r", "2",
     "--update_init_factor", "8", "--n_offsets", "5", "--anchor_capacity",
     "5000", "--images", "images_4", "-m", "out"],
], ids=["default", "cut_schedule", "preset", "preset_lod",
        "preset_voxel", "model_flags"])
def test_train_config_from_args_matches_jax(argv, jax_train_module):
    """The same argv through both packages' build_parser and
    config_from_args gives the same TrainConfig on the keys both have."""
    argv = ["-s", "scene", *argv]
    jp = jax_train_module.build_parser()
    want = json.loads(jax_train_module.config_from_args(
        jp.parse_args(argv)).to_json())
    got = json.loads(train_driver.config_from_args(
        train_driver.build_parser().parse_args(argv)).to_json())
    assert _shared(got, want) == _shared(want, got)
    shared = _shared(got, want)
    assert {"model", "opt", "pipe", "save_iterations", "test_iterations",
            "checkpoint_iterations"} <= shared.keys()
    assert {"voxel_size", "lod", "resolution", "white_background",
            "n_offsets"} <= shared["model"].keys()
    assert {"update_until", "lmbda_rec", "start_stat",
            "disable_hyper"} <= shared["opt"].keys()


@pytest.mark.parametrize("main, argv", [
    (train_driver.main, ["-s", "nowhere", "-m", "nowhere"]),
    (decompress.main, ["-s", "nowhere", "-m", "nowhere"]),
    (test_driver.main, ["-s", "nowhere", "-m", "nowhere"]),
    (bench.main, []),
    (make_synth_scene.main, ["--out", "nowhere"]),
], ids=["train", "decompress", "test", "bench", "make_synth_scene"])
def test_drivers_raise_without_a_card(main, argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert not any(tmp_path.iterdir())


def test_bench_on_the_cpu(capsys):
    assert bench.main(["--force_cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "rasterize_fwd_bwd_throughput"
    assert line["unit"] == "Mpix/s/chip" and line["device"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] >= 0


def _jax_model_dir(scene, root):
    """A JAX model directory: its cfg_args and chkpnt5.pkl (+ meta) of a
    state with non-trivial content, written by the JAX package."""
    cfg = jcfg.TrainConfig(model=jcfg.ModelConfig(n_offsets=4),
                           opt=jcfg.OptimizationConfig(iterations=5))
    xyz, _, _ = read_points3d_binary(str(scene / "sparse/0/points3D.bin"))
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0), xyz,
                                        cfg.model)
    rng = np.random.default_rng(11)

    def draw(x, s=0.5):
        return jnp.asarray(np.asarray(x) + rng.normal(size=x.shape) * s,
                           jnp.float32)

    p = model.params
    p = p._replace(anchor_feat=draw(p.anchor_feat, 2.0),
                   offsets=draw(p.offsets, 0.02),
                   mask_logit=draw(p.mask_logit),
                   mlps=jax.tree.map(lambda x: draw(x, 0.05), p.mlps))
    adam = joptim.init_adam(p)
    adam = adam._replace(mu=jax.tree.map(draw, adam.mu),
                         nu=jax.tree.map(lambda x: draw(x) ** 2, adam.nu),
                         count=jnp.asarray(5, jnp.int32))
    root.mkdir()
    (root / "cfg_args").write_text(cfg.to_json())
    jckpt.save_pytree(str(root / "chkpnt5.pkl"),
                      dict(params=p, buffers=model.buffers, adam=adam))
    with open(root / "chkpnt5.meta.pkl", "wb") as f:
        pickle.dump(dict(iteration=5, voxel_size=voxel, level_scales=None,
                         spatial_lr_scale=1.0, budget=1 << 20, vis_cap=None,
                         watermarks=(0, 0),
                         key=np.asarray(jax.random.PRNGKey(1)),
                         rng_state=np.random.default_rng(0)
                         .bit_generator.state, cam_order=[1, 0]), f)
    return cfg, p, model.buffers, adam


LOAD_WITHOUT_JAX = textwrap.dedent("""
    import json, sys, torch
    sys.modules["jax"] = None          # any import of JAX raises
    torch.set_num_threads(1)
    from contextgs_tpu_torch.drivers import read_config, test
    from contextgs_tpu_torch.models import state as st
    from contextgs_tpu_torch.utils.checkpoint import load_checkpoint
    cfg = read_config({model!r})
    model0, _ = st.init_scene_model(torch.zeros(4, 3).numpy(), cfg.model,
                                    generator=torch.Generator(),
                                    device="cpu")
    params, buffers, adam, meta = load_checkpoint({ckpt!r}, model0.params,
                                                  "cpu")
    torch.save(dict(params=st.param_leaves(params),
                    buffers=buffers._asdict(), mu=adam.mu, nu=adam.nu,
                    count=adam.count, iteration=meta["iteration"]),
               {out!r})
    code = test.main(["-s", {scene!r}, "-m", {model!r}, "--force_cpu"])
    print(json.dumps(dict(code=code, jax=sys.modules["jax"] is not None,
                          PIL="PIL" in sys.modules)))
""")


def test_jax_checkpoint_loads_without_jax(scene, tmp_path):
    """A JAX model directory reads through the port with JAX unimportable:
    the checkpoint equals convert.py's conversion of the same state, and
    the test driver encodes, decodes and scores it."""
    model = tmp_path / "jax_model"
    cfg, p, b, adam = _jax_model_dir(scene, model)
    out = tmp_path / "loaded.pt"
    got = _run(LOAD_WITHOUT_JAX.format(
        model=str(model), ckpt=str(model / "chkpnt5.pkl"), out=str(out),
        scene=str(scene)))
    assert got == dict(code=0, jax=False, PIL=False)
    loaded = torch.load(out, weights_only=True)
    ct = tcfg.ModelConfig(n_offsets=4)
    want_p = tst.param_leaves(convert.params_from_numpy(
        jax.tree.map(np.asarray, p), ct, "cpu"))
    want_adam = convert.adam_from_numpy(jax.tree.map(np.asarray, adam), ct,
                                        "cpu")
    want_b = convert.buffers_from_numpy(jax.tree.map(np.asarray, b), "cpu")
    for got_tree, want_tree in ((loaded["params"], want_p),
                                (loaded["mu"], want_adam.mu),
                                (loaded["nu"], want_adam.nu),
                                (loaded["buffers"], want_b._asdict())):
        assert list(got_tree) == list(want_tree)
        for name in want_tree:
            assert torch.equal(got_tree[name], want_tree[name]), name
    assert loaded["count"] == want_adam.count == 5
    assert loaded["iteration"] == 5
    res = _results(model)["ours_from_ckpt"]
    assert np.isfinite(res["PSNR"]) and res["size_MB"] > 0


def test_make_synth_scene_matches_jax(jax_scene, scene):
    """The port's scene against the JAX script's from the same seed: the
    COLMAP model and oracle.npz byte-identical; the ground-truth images
    (two rasterizers, float32) within one uint8 step everywhere and equal
    on at least 99% of pixels."""
    proc, jax_root = jax_scene
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    for name in SCENE_FILES:
        assert ((jax_root / name).read_bytes()
                == (scene / name).read_bytes()), name
    names = sorted(p.name for p in (scene / "images").iterdir())
    assert names == sorted(p.name for p in (jax_root / "images").iterdir())
    assert len(names) == 8
    equal = total = 0
    for name in names:
        with Image.open(jax_root / "images" / name) as im:
            want = np.asarray(im).astype(np.int64)
        got = np.asarray(Image.open(scene / "images" / name)).astype(np.int64)
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got - want).max() <= 1, name
        equal += int((got == want).sum())
        total += got.size
    assert equal >= 0.99 * total
