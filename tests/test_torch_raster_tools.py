"""The port's rasterizer-measuring scripts (`contextgs_tpu_torch/scripts/`
`profile`, `thr_sweep`, `fps_bench`, `kern_micro`, `corner_diag`) and the
rate-point launcher `r3_suite` against the JAX package's root `scripts/`
on the CPU, at small sizes.

The JAX scripts are loaded from their files (`scripts/` is no package) and
run in this process on the conftest's CPU devices; where a JAX script's
value lives inside its `main()`, a spy takes it: `thr_sweep`'s draws from
its `probe_demand` call, `fps_bench`'s decoded scene from
`make_decoded_renderer` and its chained sum from the `jax.jit` that
wraps `render_all`, `kern_micro`'s table from stubs of the two Pallas
kernels (so the full-size table is built but no kernel runs on it)."""

import ast
import functools
import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu import evaluation as jeval
from contextgs_tpu.ops.rasterize import (expand_and_sort as jax_sort,
                                         project_gaussians as jax_project,
                                         rasterize as jax_rasterize)
from contextgs_tpu.ops.rasterize import tile_kernel as jtk
from contextgs_tpu.ops.rasterize.projection import \
    ProjectedGaussians as JProjected
from contextgs_tpu.ops.rasterize.reference import \
    blend_reference as jax_blend_reference
from contextgs_tpu.ops.rasterize.sorting import TileInstances as JInstances
from contextgs_tpu.scene.cameras import Camera as JCamera
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.drivers import bench
from contextgs_tpu_torch.evaluation import make_decoded_renderer
from contextgs_tpu_torch.ops.rasterize import tile_kernel
from contextgs_tpu_torch.scripts import (chip_session, corner_diag,
                                         fps_bench, kern_micro, kvariants,
                                         pack_lab, profile, r3_micro,
                                         r3_suite, rd_finalize, rd_queue,
                                         rd_table, thr_sweep)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = ("--noise_from 10 --context_from 20 --start_stat 2 "
            "--update_from 4 --update_interval 10 --update_until 15 "
            "--n_offsets 4 --checkpoint_iterations 30")


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


class _Stop(Exception):
    """Raised by a spy once it holds what the test needs."""


# -------------------------------------------------------------- thr_sweep

@pytest.mark.parametrize("spec", ["2000x96x64", "8000x96x64", "2000x128x96"])
def test_thr_sweep_demand_matches_jax(spec, monkeypatch):
    """The port's draws equal the JAX script's (taken from its
    probe_demand call), and the port's demand equals JAX's probe_demand on
    them exactly."""
    jts = _jax_script("thr_sweep")
    seen = {}

    def spy(*args):
        seen["args"] = args
        raise _Stop

    real_probe = jts.probe_demand
    monkeypatch.setattr(jts, "probe_demand", spy)
    (g, w, h), = thr_sweep.configs(spec)
    with pytest.raises(_Stop):
        jts.measure(g, w, h, 1, None)
    means, scales, quats, opac, cam, _, _ = seen["args"]
    want = real_probe(means, scales, quats, opac, cam, w, h)

    got_in = thr_sweep.inputs(g, torch.device("cpu"))
    for name, a, b in zip(("means", "scales", "quats", "opacities"),
                          (got_in[0], got_in[1], got_in[2], got_in[4]),
                          (means, scales, quats, opac)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    cam_kw = bench.camera_kwargs(w, h, "cpu")
    np.testing.assert_array_equal(cam_kw["world_view"].numpy(),
                                  cam.world_view.astype(np.float32))
    np.testing.assert_array_equal(cam_kw["full_proj"].numpy(),
                                  cam.full_proj.astype(np.float32))
    got = thr_sweep.probe_demand(got_in[0], got_in[1], got_in[2], got_in[4],
                                 cam_kw)
    assert got == want > 0


def test_thr_sweep_200k_row_is_the_bench_frame():
    """At 200k, s_hi = 0.02 and 0.2·0.02 == 0.004 in float64: the 200k row
    draws bench.py's frame."""
    assert 0.2 * 0.02 == 0.004
    for a, b in zip(thr_sweep.inputs(200_000, "cpu"),
                    bench.inputs(200_000, "cpu")):
        assert torch.equal(a, b)


def test_thr_sweep_main_prints_each_row(capsys):
    """main on the CPU: a row a config with its demand, peak memory not
    measured."""
    assert thr_sweep.main(["--force_cpu", "--iters", "1", "--configs",
                           "2000x96x64,1000x64x48"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["gaussians", "res", "ms/iter", "Mpix/s",
                                "demand", "peak", "GiB"]
    for line, (g, w, h) in zip(lines[1:], ((2000, 96, 64), (1000, 64, 48))):
        cols = line.split()
        cam_kw = bench.camera_kwargs(w, h, "cpu")
        means, scales, quats, _, opac = thr_sweep.inputs(g, "cpu")
        assert cols[:2] == [str(g), f"{w}x{h}"]
        assert int(cols[4]) == thr_sweep.probe_demand(means, scales, quats,
                                                       opac, cam_kw)
        assert float(cols[2]) > 0 and "not measured (cpu)" in line
    assert len(lines) == 3


# ---------------------------------------------------------------- profile

def test_profile_small_frame_matches_jax(capsys):
    """On 2,000 gaussians at 96x64: the instance count equals the demand
    of JAX's expand_and_sort, the plain K1's image equals JAX's rasterize
    (reference backend) within 2e-5, and the stage lines come out in
    order after the E2E line."""
    w, h, g = 96, 64, 2000
    arrays = bench.inputs(g, "cpu")
    cam = JCamera(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3), fov_x=1.2,
                  fov_y=2 * np.arctan(np.tan(0.6) * h / w), image=None,
                  width=w, height=h)
    cam_np = dict(world_view=cam.world_view, full_proj=cam.full_proj,
                  tanfovx=cam.tanfovx, tanfovy=cam.tanfovy)

    @jax.jit
    def jax_frame(means, scales, quats, colors, opac):
        proj = jax_project(means, scales, quats, cam.world_view,
                           cam.full_proj, cam.tanfovx, cam.tanfovy, w, h,
                           opacities=opac)
        out = jax_rasterize(means, scales, quats, colors, opac, width=w,
                            height=h, bg=jnp.zeros(3), budget=4096,
                            chunk_size=128, backend="reference", **cam_np)
        return jax_sort(proj, 6, 4, 4096, align=128).demand, out.image

    demand, image = jax_frame(*(x.numpy() for x in arrays))
    demand, image = int(demand), np.asarray(image)

    with torch.no_grad():
        calls, counts = profile.stage_calls(
            *arrays, bench.camera_kwargs(w, h, "cpu"))
        rgb, _, _ = calls["blend fwd (K1)"]()
    assert list(calls) == list(profile.STAGES)
    assert counts["instances"] == demand > 0
    np.testing.assert_allclose(rgb.numpy(), image, atol=2e-5)

    res = profile.measure("cpu", g, w, h, 1)
    assert res["instances"] == demand
    assert list(res["stages"]) == list(profile.STAGES)
    assert all(s["device_ms"] is None for s in res["stages"].values())
    capsys.readouterr()
    profile.report(res)
    names = [ln[:28].strip() for ln in capsys.readouterr().out.splitlines()]
    assert names[1:9] == ["E2E fwd+bwd", *profile.STAGES, "TOTAL (stages)"]


# -------------------------------------------------------------- fps_bench

class _JaxJitSpy:
    """Stands in for the `jax` module of the JAX script: every function the
    script jits keeps its outputs in `outs`."""

    def __init__(self):
        self.outs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def call(*args):
            out = jitted(*args)
            self.outs.append(out)
            return out
        return call


def test_fps_bench_chained_sum_matches_jax(monkeypatch, capsys):
    """300 anchors at ModelConfig widths, 3 views at 64x48: the port's
    draws equal the JAX script's scene; with the JAX MLPs carried across by
    convert.py, the port's chained sum of the images' means is within 1e-5
    relative of JAX's render_all, and the naive and chained images are
    equal."""
    jfb = _jax_script("fps_bench")
    spy = _JaxJitSpy()
    scenes = []

    def capture(dec, *args, **kw):
        scenes.append(dec)
        return real(dec, *args, **kw)

    real = jeval.make_decoded_renderer
    monkeypatch.setattr(jeval, "make_decoded_renderer", capture)
    monkeypatch.setattr(jfb, "jax", spy)
    w, h, views, n = 64, 48, 3, 300
    _run_jax(jfb, ["--anchors", str(n), "--views", str(views), "--width",
                   str(w), "--height", str(h)], monkeypatch, capsys)
    want = float(spy.outs[-1][0])
    assert not bool(spy.outs[-1][1])            # no overflow in JAX's run

    mcfg = tcfg.ModelConfig(feat_dim=50, n_offsets=10)
    dec = fps_bench.decoded_scene(n, 0, mcfg, "cpu")
    jdec = convert.decoded_scene_from_numpy(
        jax.tree.map(np.asarray, scenes[0]), mcfg, "cpu")
    for name in ("anchor", "feat", "scaling", "offsets", "masks", "hyper"):
        assert torch.equal(getattr(dec, name), getattr(jdec, name)), name
    cfg = tcfg.TrainConfig(model=mcfg,
                           pipe=tcfg.PipelineConfig(chunk_size=128))
    render = make_decoded_renderer(dec._replace(mlps=jdec.mlps), cfg, w, h,
                                   "cpu")
    cams = fps_bench.orbit(views, w, h)
    bg = np.zeros(3, np.float32)
    naive_imgs, chained_imgs = [], []
    _, naive_sum = fps_bench.naive(render, cams, bg, naive_imgs)
    _, chained_sum = fps_bench.chained(render, cams, bg, chained_imgs)
    assert all(torch.equal(a, b) for a, b in zip(naive_imgs, chained_imgs))
    assert len(chained_imgs) == views
    assert float(naive_sum) == float(chained_sum)
    assert abs(float(chained_sum) - want) <= 1e-5 * abs(want)
    assert want > 0


# ------------------------------------------------------------- kern_micro

def test_kern_micro_table_is_the_jax_scripts(monkeypatch, capsys):
    """The JAX script's table, as its two kernels receive it (stubs that
    keep it through a debug callback and return zeros), equals
    kvariants.lab_inputs for every config: rows = packed[:9].T, gauss_ids
    = arange, the same tile bounds."""
    jkm = _jax_script("kern_micro")
    seen = {}

    def keep(packed, bounds):
        key = np.asarray(bounds).tobytes()
        if key not in seen:
            seen[key] = (np.array(packed), np.array(bounds))

    def fwd_stub(p, b, n_tiles, tiles_x, tile, chunk, interpret):
        jax.debug.callback(keep, p, b)
        n_pad = -(-n_tiles // jtk.TILES_PER_STEP) * jtk.TILES_PER_STEP
        return (jnp.zeros((jtk.OUTC, n_pad * jtk.PIX), jnp.float32),
                jnp.zeros((n_pad,), jnp.int32))

    def bwd_stub(p, b, *rest):
        jax.debug.callback(keep, p, b)
        return jnp.zeros(p.shape, jnp.float32)

    monkeypatch.setattr(jtk, "blend_forward_pallas", fwd_stub)
    monkeypatch.setattr(jtk, "blend_backward_pallas", bwd_stub)
    out = _run_jax(jkm, ["--iters", "1"], monkeypatch, capsys)
    assert len(out.splitlines()) == len(kern_micro.CONFIGS)
    assert len(seen) == len(kern_micro.CONFIGS)
    first = None
    for (cpt, every), (packed, bounds) in zip(kern_micro.CONFIGS,
                                              seen.values()):
        label = f"{cpt}x{3600 // every}"
        rows, ids, tb = kvariants.lab_inputs(cpt, 3600 // every,
                                             device="cpu")
        np.testing.assert_array_equal(tb.numpy(), bounds, err_msg=label)
        np.testing.assert_array_equal(ids.numpy(),
                                      np.arange(packed.shape[1]))
        if first is None:
            np.testing.assert_array_equal(rows.numpy(), packed[:9].T)
            assert not packed[9:].any()
            first = packed
        else:
            assert np.array_equal(packed, first), label


def _pallas_forward(rows, bounds, width, height):
    """JAX's Pallas K1 in interpret mode on K1's table → (rgb [3,H,W],
    T [H,W])."""
    tiles_x, tiles_y = width // 16, height // 16
    packed = np.zeros((jtk.PACK, rows.shape[0]), np.float32)
    packed[:9] = rows.numpy().T
    out, _ = jax.jit(functools.partial(
        jtk.blend_forward_pallas, n_tiles=tiles_x * tiles_y,
        tiles_x=tiles_x, tile_size=16, chunk_size=128, interpret=True))(
        jnp.asarray(packed), jnp.asarray(bounds.numpy()))
    full = np.asarray(out)[:, :tiles_x * tiles_y * 256].reshape(
        4, tiles_y, tiles_x, 16, 16).transpose(0, 1, 3, 2, 4).reshape(
        4, height, width)
    return full[:3], full[3]


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_oracle(proj, inst, rows, width, height):
    return jax_blend_reference(proj, inst, rows[:, 6:9], rows[:, 5], width,
                               height)


def _oracle_forward(rows, ids, bounds, width, height):
    """JAX's blend_reference oracle on K1's table."""
    n_tiles = bounds.numel() - 1
    b = bounds.numpy()
    pos = np.arange(ids.numel())
    tile = np.searchsorted(b, pos, side="right") - 1
    r = rows.numpy()
    proj = JProjected(means2d=r[:, 0:2], conics=r[:, 2:5], depths=None,
                      radii=None, rect_min=None, rect_max=None, n_tiles=None)
    inst = JInstances(*([None] * len(JInstances._fields)))._replace(
        gauss_ids=ids.numpy(), tile_ids=np.where(pos < b[-1], tile, n_tiles),
        valid=pos < b[-1], tile_bounds=b)
    img, t = _jax_oracle(proj, inst, r, width, height)
    return np.asarray(img), np.asarray(t)


@pytest.mark.parametrize("cpt,every", kern_micro.CONFIGS[:3])
def test_kern_micro_cut_table_matches_jax(cpt, every):
    """On the table cut to 8x4 tiles (budget 2048): the plain K1 against
    JAX's Pallas kernel in interpret mode on single-chunk tiles, and
    against JAX's blend_reference on multi-chunk ones (the Pallas kernel
    restarts T at chunk boundaries, ROADMAP.md queue 3), 2e-5; K2's plain
    version gives finite gradients; the rows' times and counts."""
    w, h, active = 128, 64, 32 // every
    rows, ids, bounds = kvariants.lab_inputs(cpt, active, tiles_x=8,
                                             tiles_y=4, budget=2048,
                                             device="cpu")
    rgb, ft, _ = tile_kernel.blend_forward(rows, ids, bounds, w, h)
    want = (_pallas_forward(rows, bounds, w, h) if cpt == 1
            else _oracle_forward(rows, ids, bounds, w, h))
    np.testing.assert_allclose(rgb.numpy(), want[0], atol=2e-5)
    np.testing.assert_allclose(ft.numpy(), want[1], atol=2e-5)
    assert float(ft.min()) < 0.5                # some instance meets a tile

    res, = kern_micro.measure("cpu", 1, ((cpt, every),), tiles_x=8,
                              tiles_y=4, budget=2048)
    assert res["instances"] == cpt * active * 128
    assert res["active_tiles"] == active
    assert res["label"] == f"{cpt} chunk x {active:4d} tiles " \
        f"({cpt * active}ch)"
    assert 0 < res["reaching_pairs"] < res["instances"] * 256
    assert res["fwd_ms"] > 0 and res["bwd_ms"] > 0


def test_kern_micro_keeps_each_configs_kernel_args():
    """With keep_kernel_args each row holds the K1 and K2 arguments it
    timed: the config's table, K1's outputs on it and cotangents of ones,
    so that a caller can hold both kernels against their plain versions
    on every config (the configs whose plain versions are quick on the
    CPU)."""
    w, h = 128, 64
    configs = ((1, 1), (2, 2), (2, 1))
    table = kern_micro.measure("cpu", 1, configs, tiles_x=8, tiles_y=4,
                               budget=4096, keep_kernel_args=True)
    assert len(table) == len(configs)
    for (cpt, every), row in zip(configs, table):
        a1 = row["kernel_args"]["blend_forward"]
        a2 = row["kernel_args"]["blend_backward"]
        rows, ids, bounds = kvariants.lab_inputs(cpt, 32 // every, tiles_x=8,
                                                 tiles_y=4, budget=4096,
                                                 device="cpu")
        for got, want in zip(a1[:3], (rows, ids, bounds)):
            assert torch.equal(got, want)
        assert a1[3:] == (w, h) and a2[8:] == (w, h)
        assert all(a is b for a, b in zip(a2[:3], a1[:3]))
        fwd = tile_kernel.blend_forward(*a1)
        for got, want in zip(a2[3:6], fwd):
            assert torch.equal(got, want)
        assert bool((a2[6] == 1).all()) and bool((a2[7] == 1).all())
        d_rows = tile_kernel.blend_backward(*a2)
        assert d_rows.shape == rows.shape
        assert bool(torch.isfinite(d_rows).all())


def test_kern_micro_reaching_pairs_counts_k1s_alphas():
    """reaching_pairs equals the pairs with alpha >= 1/255 that the plain
    K1 counts where no pixel's T falls below t_eps (one chunk a tile on a
    sparse 16x8-tile view)."""
    rows, ids, bounds = kvariants.lab_inputs(1, 128, tiles_x=16, tiles_y=8,
                                             budget=2048, device="cpu")
    from contextgs_tpu_torch.ops.rasterize.reference import \
        blend_tiles_reference
    _, ft, _, pairs = blend_tiles_reference(rows, ids, bounds, 256, 128, 16,
                                            count_pairs=True)
    assert float(ft.min()) > 1e-4 * 100
    assert kern_micro.reaching_pairs(rows, ids, bounds, 16) == \
        pairs["tested"] > 0


# ------------------------------------------------------------ corner_diag

def test_corner_diag_matches_jax(monkeypatch, capsys):
    """JAX's main() against the port's --force_cpu run at 3,000 gaussians,
    128x96: the same demands, n_valid and n_wasted."""
    out = _run_jax(_jax_script("corner_diag"),
                   ["--n_gauss", "3000", "--width", "128", "--height", "96",
                    "--budget", "65536"], monkeypatch, capsys)
    want = ast.literal_eval(out.strip().splitlines()[-1])
    assert corner_diag.main(["--n_gauss", "3000", "--width", "128",
                             "--height", "96", "--force_cpu"]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in ("demand_plain", "demand_tight", "n_valid", "n_wasted",
                "wasted_frac", "bbox_gain"):
        assert got[key] == want[key], key
    assert got["n_valid"] == got["demand_tight"] > got["n_wasted"] > 0


# --------------------------------------------------------------- r3_suite

def test_r3_suite_layout_skip_and_rd_table(tmp_path, monkeypatch, capsys):
    """--force_cpu, one λ on a 64x64 scene of 8 cameras and 300 points, 30
    steps: the summary entry's keys and the l{λ:g} layout; a second call
    skips the λ; the port's rd_table and the JAX package's print the same
    table from the directory."""
    out = tmp_path / "r3"
    argv = ["--out", str(out), "--res", "64", "--cams", "8", "--gauss",
            "2000", "--points", "300", "--iters", "30", "--lmbdas", "0.004",
            "--extra_flags", SCHEDULE, "--force_cpu"]
    assert r3_suite.main(argv) == 0
    entries = [json.loads(x) for x in
               (out / "summary.jsonl").read_text().splitlines()]
    assert len(entries) == 1
    e = entries[0]
    assert {"lmbda", "iters", "wall_s", "rc", "results"} <= set(e)
    assert e["lmbda"] == 0.004 and e["iters"] == 30 and e["rc"] == 0
    assert (out / "l0.004" / "results.json").exists()
    assert (out / "scene" / "sparse" / "0" / "points3D.bin").exists()
    assert math.isfinite(e["results"]["ours"]["PSNR"])

    capsys.readouterr()
    assert r3_suite.main(argv) == 0
    assert "skip λ=0.004 (done)" in capsys.readouterr().out
    assert len((out / "summary.jsonl").read_text().splitlines()) == 1

    assert rd_table.main(["--out", str(out)]) == 0
    got = capsys.readouterr().out
    want = _run_jax(_jax_script("rd_table"), ["--out", str(out)],
                    monkeypatch, capsys)
    assert got == want
    assert "| 0.004 | 30 | " in got


# ------------------------------------------------- the CPU gate, refusals

MAINS = {
    "profile": (profile, ["--gauss", "50", "--width", "32", "--height", "32",
                          "--iters", "1"]),
    "thr_sweep": (thr_sweep, ["--iters", "1", "--configs", "50x32x32"]),
    "fps_bench": (fps_bench, ["--anchors", "20", "--views", "2", "--width",
                              "32", "--height", "32"]),
    "kern_micro": (kern_micro, ["--iters", "1", "--tiles", "8x4"]),
    "corner_diag": (corner_diag, ["--n_gauss", "50", "--width", "32",
                                  "--height", "32"]),
    "r3_suite": (r3_suite, ["--lmbdas", "0.004", "--iters", "1"]),
    "rd_queue": (rd_queue, ["--lmbdas", "0.002", "--iters", "1",
                            "--no_wait"]),
    "rd_finalize": (rd_finalize, []),
    "chip_session": (chip_session, []),
    "r3_micro": (r3_micro, ["--iters", "1"]),
    "pack_lab": (pack_lab, ["--iters", "1"]),
}
# the launchers write under --out: they must raise before they make it
WITH_OUT = ("r3_suite", "rd_queue", "rd_finalize", "chip_session")


@pytest.mark.parametrize("name", sorted(MAINS))
def test_scripts_raise_without_a_card(name, monkeypatch, tmp_path):
    """Without --force_cpu and without a card each script raises before it
    does any work (the launchers before they make a directory)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = MAINS[name]
    out = tmp_path / "out"
    if name in WITH_OUT:
        argv = [*argv, "--out", str(out)]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main(argv)
    assert not out.exists()


@pytest.mark.parametrize("name,flag", [
    ("profile", "--budget"), ("profile", "--chunk"),
    ("thr_sweep", "--budget_per_mpix"), ("fps_bench", "--budget"),
    ("kern_micro", "--budget"), ("kern_micro", "--chunk"),
    ("corner_diag", "--budget"), ("rd_queue", "--train_vis_cap")])
def test_scripts_refuse_tpu_knobs(name, flag, capsys):
    """The JAX scripts' TPU knobs fail the parse, with the reason."""
    module, argv = MAINS[name]
    with pytest.raises(SystemExit) as exc:
        module.main([*argv, flag, "65536", "--force_cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is refused: the port's" in err
