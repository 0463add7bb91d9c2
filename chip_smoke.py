#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`contextgs_tpu_torch`) on one NVIDIA
card: the quickest proof that the port builds and serves on the GPU.

    python3 chip_smoke.py

Phases, one JSON object per line; any failed check exits non-zero:

1. device  — the card's name and power limit; K1 built from the sources in
   the checkout (nvcc, sm_90a).
2. k1_check — K1 against its plain PyTorch version on the card: golden small
   cases (2e-5), then a 1280x720 view of a 20k-anchor decoded scene (max
   2e-4, mean 1e-6: an include decision at T·(1-α) ≈ 1e-4 may flip between
   the plain version's log-space prefix and the kernel's sequential product,
   and each flip moves a pixel by at most α·T ≤ 1e-4).
3. serve — the main path at full width: a decoded scene of ModelConfig()
   width (feat_dim 50, 10 offsets) and 100k anchors, built with the recipe of
   scripts/fps_bench.py from a seed, rendered by make_decoded_renderer →
   render_set over a full orbit of 32 views at 1280x720 (the first 5 are
   render_set's warm-up) and scored by evaluate_images against a seeded
   target. K1's launch count is set to 0 just before and read just after,
   and must equal the number of views; K1's inputs of the last view are kept
   from this run. Then a second pass over the orbit with CUDA events around
   the renderer's module-level calls (the stage split), K1 checked, timed and
   bounded on the kept inputs, the small CPU-vs-card check, and
   render(phase="plain") from init_scene_model over a seeded 100k-point
   cloud.
4. the `kernels` line, then the card line from nvidia-smi, then the result.
"""

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1280, 720
N_VIEWS = 32                 # a full orbit
WARMUP = 5                   # render_set leaves the first 5 views out
PEAK_FP32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
# exp on the special-function units: 16 results per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# float32 operations K1 spends on a (pixel, instance) pair, by how far the
# pair gets in the kernel's loop (csrc/blend_forward.cu), keyed as the plain
# version's pair counts: every pair walked takes dx, dy and power (11); one
# with power <= 0 takes the exp (counted on the SFU) and min(0.99, op·e)
# (2); one with alpha >= 1/255 takes T·(1-α) (2); one blended takes α·T and
# three rgb multiply-adds (7).
OPS = dict(evaluated=11, exp=2, tested=2, blended=7)
# the renderer's module-level calls the stage split times, in call order
STAGES = ("visible_filter", "decode_neural_gaussians", "project_gaussians",
          "expand_and_sort", "blend_forward")
# what the split keeps of a stage's output: decoded gaussians, and the
# instance count and gaussians touching a tile
STAGE_COUNTS = {
    "decode_neural_gaussians": lambda ng: ng.xyz.shape[0],
    "expand_and_sort": lambda inst: (inst.demand, inst.n_vis)}


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps):
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def decoded_scene(n_anchors, seed, cfg, dev):
    """The recipe of scripts/fps_bench.py:55-63, seeded from numpy."""
    from contextgs_tpu_torch.compression.codec import DecodedScene
    from contextgs_tpu_torch.models.mlps import init_decoder_mlps

    rng = np.random.default_rng(seed)
    n, f, k = n_anchors, cfg.feat_dim, cfg.n_offsets

    def put(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    return DecodedScene(
        anchor=put(rng.uniform(-2, 2, (n, 3))),
        feat=put(rng.normal(size=(n, f)) * 0.3),
        scaling=put(rng.uniform(0.01, 0.05, (n, 6))),
        offsets=put(rng.normal(size=(n, k, 3)) * 0.3),
        masks=put(rng.random((n, k)) < 0.7),
        hyper=put(np.zeros((n, f // cfg.hyper_divisor))),
        mlps=init_decoder_mlps(cfg, torch.Generator().manual_seed(seed), dev),
        prior=None, level_scales=[], voxel_size=0.001)


def orbit_cameras(n, width, height, target_seed):
    from contextgs_tpu_torch.scene.cameras import Camera

    rng = np.random.default_rng(target_seed)
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        Rm = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
        target = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
        cams.append(Camera(uid=i, colmap_id=i, R=Rm,
                           T=np.array([0.0, 0.0, 4.0]), fov_x=1.2,
                           fov_y=2 * math.atan(math.tan(0.6) * height / width),
                           image=target, width=width, height=height))
    return cams


@contextlib.contextmanager
def wrapped(module, name, wrap):
    """Replace `module.name` by `wrap(original)` for the block."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def keep_args(store):
    """Wrapper that keeps the arguments of the last call in `store`."""
    def wrap(fn):
        def call(*args):
            store["args"] = args
            return fn(*args)
        return call
    return wrap


def timed_call(name, log, summary=lambda out: None):
    """Wrapper that brackets each call with CUDA events, logged as
    (name, start, end, summary(output))."""
    def wrap(fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            log.append((name, start, end, summary(out)))
            return out
        return call
    return wrap


def stage_targets():
    """(module, name) of each stage: the names the decoded renderer and
    rasterize look up at call time."""
    import contextgs_tpu_torch.evaluation as tev
    import contextgs_tpu_torch.ops.rasterize as trz

    return [(tev if n == "decode_neural_gaussians" else trz, n)
            for n in STAGES]


def render_keeping_k1(render, cam, bg):
    """One view through the renderer; returns K1's arguments from it."""
    import contextgs_tpu_torch.ops.rasterize as trz

    store = {}
    with wrapped(trz, "blend_forward", keep_args(store)):
        render(cam.as_device_dict(), bg)
    return store["args"]


def compare_k1(rows, ids, bounds, width, height, t_eps=1e-4):
    """K1 against its plain version on the same card inputs."""
    from contextgs_tpu_torch.ops.rasterize import reference, tile_kernel

    got = tile_kernel.blend_forward(rows, ids, bounds, width, height, t_eps)
    want = reference.blend_tiles_reference(rows, ids, bounds, width, height,
                                           (width + 15) // 16, t_eps=t_eps)
    torch.cuda.synchronize()
    diff = torch.cat([(got[0] - want[0]).abs().flatten(),
                      (got[1] - want[1]).abs().flatten()])
    pix = torch.maximum((got[0] - want[0]).abs().amax(0),
                        (got[1] - want[1]).abs())
    return dict(max_abs=float(diff.max()), mean_abs=float(diff.mean()),
                pixels_over_2e5=int((pix > 2e-5).sum()),
                last_contrib_mismatch=int((got[2] != want[2]).sum()),
                finite=bool(torch.isfinite(got[0]).all()
                            and torch.isfinite(got[1]).all()))


def golden_cases(dev):
    """Small blend cases: random rows 48x32, an occluder, and the case where
    the Pallas forward resets T at a chunk boundary (kernel must give G=0)."""
    rng = np.random.default_rng(11)
    n = 300
    rows = np.zeros((n, 9), np.float32)
    rows[:, 0] = rng.uniform(-4, 52, n)
    rows[:, 1] = rng.uniform(-4, 36, n)
    a, c = rng.uniform(0.005, 0.5, n), rng.uniform(0.005, 0.5, n)
    rows[:, 2:5] = np.stack([a, rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c),
                             c], 1)
    rows[:, 5] = rng.uniform(0.05, 1.0, n)
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    tiles = np.sort(rng.integers(0, 6, 4 * n))
    random_case = (rows, rng.integers(0, n, tiles.size).astype(np.int32),
                   np.searchsorted(tiles, np.arange(7)).astype(np.int32),
                   48, 32)
    occ = np.zeros((2, 9), np.float32)
    occ[:, 0:2] = 15.5
    occ[:, 2] = occ[:, 4] = 0.002
    occ[:, 5] = [1.0, 0.9]          # T·(1-α) stays clear of the 1e-4 cut
    occ[0, 6] = occ[1, 7] = 1.0
    occluder_case = (occ, np.int32([0, 1] * 4), np.int32([0, 2, 4, 6, 8]),
                     32, 32)
    cb = np.zeros((384, 9), np.float32)
    cb[:, 0:2] = 7.5
    cb[:, 2] = cb[:, 4] = 1e-4
    cb[:3, 5] = [0.99, 0.98, 0.99]
    cb[:3, 6] = 1.0
    cb[256, 5] = 0.3
    cb[256, 7] = 1000.0
    chunk_case = (cb, np.arange(384, dtype=np.int32), np.int32([0, 384]),
                  16, 16)
    for name, (r, i, b, w, h) in (("random_48x32", random_case),
                                  ("occluder", occluder_case),
                                  ("chunk_boundary", chunk_case)):
        yield name, (torch.from_numpy(r).to(dev), torch.from_numpy(i).to(dev),
                     torch.from_numpy(b).to(dev), w, h)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from contextgs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                            PipelineConfig, TrainConfig)
    from contextgs_tpu_torch.evaluation import (evaluate_images,
                                                make_decoded_renderer,
                                                render_set)
    from contextgs_tpu_torch.models import renderer as trenderer
    from contextgs_tpu_torch.models import state as tst
    from contextgs_tpu_torch.ops import cuda_build
    from contextgs_tpu_torch.ops.rasterize import reference, tile_kernel

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device + build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_build.build([tile_kernel.SOURCE])
    build_s = time.perf_counter() - t0
    ptxas = cuda_build.build_log.get("blend_forward", {}).get("ptxas", "")
    emit(phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         k1_build_s=build_s,
         k1_ptxas=[ln.strip() for ln in ptxas.splitlines() if "Used" in ln])

    # ---- 2. K1 against its plain version ----
    for name, (rows, ids, bounds, w, h) in golden_cases(dev):
        res = compare_k1(rows, ids, bounds, w, h)
        emit(phase="k1_check", case=name, **res)
        check(res["finite"] and res["max_abs"] <= 2e-5, f"K1 golden {name}")
        check(res["last_contrib_mismatch"] == 0, f"K1 last_contrib {name}")
    got_g = tile_kernel.blend_forward(*next(iter(
        c for n, c in golden_cases(dev) if n == "chunk_boundary")))[0][1]
    check(float(got_g.abs().max()) == 0.0, "chunk-boundary green must be 0")

    cfg = TrainConfig(model=ModelConfig())
    mcfg = cfg.model
    bg = np.zeros(3, np.float32)
    dec20 = decoded_scene(20_000, 20, mcfg, dev)
    rows, ids, bounds = render_keeping_k1(
        make_decoded_renderer(dec20, cfg, W, H), orbit_cameras(1, W, H, 20)[0],
        bg)[:3]
    res = compare_k1(rows, ids, bounds, W, H)
    emit(phase="k1_check", case="decoded_20k_1280x720",
         n_gauss=int(rows.shape[0]), n_instances=int(ids.numel()),
         n_vis=int(torch.unique(ids).numel()), **res)
    check(res["finite"] and res["max_abs"] <= 2e-4
          and res["mean_abs"] <= 1e-6, "K1 at 1280x720, 20k anchors")
    del dec20, rows, ids, bounds

    # ---- 3. the main path: serve a 100k-anchor decoded scene ----
    import contextgs_tpu_torch.ops.rasterize as trz

    dec = decoded_scene(100_000, 0, mcfg, dev)
    cams = orbit_cameras(N_VIEWS, W, H, 1)
    render = make_decoded_renderer(dec, cfg, W, H)
    render(cams[0].as_device_dict(), bg)        # allocator warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_kept, view_ms = {}, []
    with wrapped(trz, "blend_forward", keep_args(k1_kept)):
        tile_kernel.launches = 0
        renders, gts, fps = render_set(render, cams, bg, view_ms=view_ms)
        torch.cuda.synchronize()
        k1_launches = tile_kernel.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = evaluate_images(renders, gts)
    timed = view_ms[WARMUP:]
    emit(phase="serve", views=N_VIEWS, timed_views=len(timed), width=W,
         height=H, anchors=100_000, ms_per_view=1e3 / fps, fps=fps,
         view_ms_median=float(np.median(timed)), view_ms_min=min(timed),
         view_ms_max=max(timed), k1_launches=k1_launches,
         peak_mem_gib=peak_gib, PSNR=metrics["PSNR"], SSIM=metrics["SSIM"],
         LPIPS=metrics["LPIPS"])
    check(k1_launches == N_VIEWS, "K1 launches on the main path != views")
    check(all(tuple(r.shape) == (3, H, W) and bool(torch.isfinite(r).all())
              for r in renders), "renders finite [3,H,W]")
    check(math.isfinite(metrics["PSNR"]) and math.isfinite(metrics["SSIM"]),
          "PSNR/SSIM finite")

    # stage split: the orbit again, CUDA events around the renderer's
    # module-level calls (these K1 launches are not the main path's)
    log, split_view_ms = [], []
    with contextlib.ExitStack() as stack:
        for module, name in stage_targets():
            stack.enter_context(wrapped(module, name, timed_call(
                name, log, STAGE_COUNTS.get(name, lambda out: None))))
        split_renders, _, _ = render_set(render, cams, bg,
                                         view_ms=split_view_ms)
    torch.cuda.synchronize()
    check(len(log) == len(STAGES) * N_VIEWS, "one call of each stage a view")
    check(all(float((a - b).abs().max()) <= 1e-6
              for a, b in zip(renders, split_renders)),
          "the timed pass renders what the main path rendered")
    del split_renders
    views = [log[i:i + len(STAGES)] for i in range(0, len(log), len(STAGES))]
    split = {f"{n}_ms": 0.0 for n in STAGES}
    for view in views[WARMUP:]:
        for name, start, end, _ in view:
            split[f"{name}_ms"] += start.elapsed_time(end) / len(timed)
    split["view_ms"] = float(np.mean(split_view_ms[WARMUP:]))
    split["other_ms"] = split["view_ms"] - sum(split[f"{n}_ms"]
                                               for n in STAGES)
    by_name = [{name: out for name, _, _, out in view} for view in views]
    emit(phase="serve_split", **split,
         n_gauss=[v["decode_neural_gaussians"] for v in by_name],
         n_instances=[v["expand_and_sort"][0] for v in by_name],
         n_vis=[int(v["expand_and_sort"][1]) for v in by_name])
    del log, views, by_name

    # K1 on the main path's inputs (last view): check, time, bound
    rows, ids, bounds, _, _, t_eps = k1_kept["args"]
    k1_res = compare_k1(rows, ids, bounds, W, H, t_eps)
    emit(phase="k1_check", case="serve_100k_1280x720", **k1_res)
    check(k1_res["finite"] and k1_res["max_abs"] <= 2e-4
          and k1_res["mean_abs"] <= 1e-6, "K1 on the main path's inputs")
    k1_ms = cuda_ms(lambda: tile_kernel.blend_forward(rows, ids, bounds, W, H,
                                                      t_eps), 20)
    plain_ms = cuda_ms(lambda: reference.blend_tiles_reference(
        rows, ids, bounds, W, H, W // 16, t_eps=t_eps), 3)
    pairs = reference.blend_tiles_reference(rows, ids, bounds, W, H, W // 16,
                                            t_eps=t_eps, count_pairs=True)[3]
    # bytes: the rows of gaussians that have tile instances, ids and bounds
    # read once, rgb, final T and last_contrib written once
    rows_read = int(torch.unique(ids).numel())
    n_bytes = (rows_read * rows.shape[1] * 4 + ids.numel() * 4
               + bounds.numel() * 4 + H * W * (3 + 1 + 1) * 4)
    n_ops = sum(OPS[k] * pairs[k] for k in OPS)
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    ops_ms = n_ops / PEAK_FP32_FLOPS * 1e3
    exp_ms = pairs["exp"] / SFU_EXP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms, exp_ms)
    emit(phase="k1_bound", pairs=pairs, pairs_listed=256 * int(ids.numel()),
         rows_read=rows_read, bytes=n_bytes, fp32_ops=n_ops,
         bytes_ms=bytes_ms, fp32_ops_ms=ops_ms, exp_ms=exp_ms,
         bound_ms=bound_ms, k1_ms=k1_ms, plain_ms=plain_ms,
         share_of_bound=bound_ms / k1_ms)

    # CPU-vs-card check of the whole decoded-render path at a small size
    small_cfg = TrainConfig(model=ModelConfig())
    dec_s = decoded_scene(2_000, 5, small_cfg.model, dev)
    cam_s = orbit_cameras(1, 128, 96, 5)[0].as_device_dict()
    img_gpu = make_decoded_renderer(dec_s, small_cfg, 128, 96)(cam_s, bg)
    dec_cpu = dec_s._replace(**{k: getattr(dec_s, k).cpu() for k in
                                ("anchor", "feat", "scaling", "offsets",
                                 "masks", "hyper")},
                             mlps=dec_s.mlps.cpu())
    img_cpu = make_decoded_renderer(dec_cpu, small_cfg, 128, 96,
                                    device="cpu")(cam_s, bg)
    d = (img_gpu.cpu() - img_cpu).abs()
    emit(phase="e2e_small_cpu_vs_card", max_abs=float(d.max()),
         mean_abs=float(d.mean()), nonzero=float(img_cpu.abs().sum()))
    check(float(d.max()) <= 2e-3 and float(d.mean()) <= 1e-5
          and float(img_cpu.abs().sum()) > 1.0, "small render CPU vs card")

    # render(phase="plain") from the port's own init over a 100k-point cloud
    rng = np.random.default_rng(7)
    pts = rng.uniform(-2, 2, (100_000, 3))
    model, voxel = tst.init_scene_model(
        pts, mcfg, generator=torch.Generator().manual_seed(7))
    p = model.params
    n_cap = p.anchor.shape[0]
    p = p._replace(
        anchor_feat=torch.from_numpy(rng.normal(
            size=(n_cap, mcfg.feat_dim)).astype(np.float32) * 0.3).to(dev),
        offsets=torch.from_numpy(rng.normal(
            size=(n_cap, mcfg.n_offsets, 3)).astype(np.float32)).to(dev))
    tile_kernel.launches = 0
    with torch.no_grad():
        out = trenderer.render(p, model.buffers, mcfg, OptimizationConfig(),
                               PipelineConfig(), cams[0].as_device_dict(), W,
                               H, torch.zeros(3, device=dev), phase="plain")
    torch.cuda.synchronize()
    plain_launches = tile_kernel.launches
    emit(phase="render_plain", anchors=int(model.buffers.alive.sum()),
         capacity=n_cap, voxel_size=voxel, k1_launches=plain_launches,
         n_instances=out.n_instances, n_vis=int(out.n_vis),
         image_sum=float(out.image.sum()),
         finite=bool(torch.isfinite(out.image).all()))
    check(plain_launches == 1, "render(phase='plain') launched K1 once")
    check(bool(torch.isfinite(out.image).all())
          and float(out.image.abs().sum()) > 1.0, "render_plain image")

    # ---- 4. kernels line, card line, result ----
    kernels = [dict(
        name="blend_forward", route="cuda",
        source="contextgs_tpu_torch/ops/rasterize/csrc/blend_forward.cu",
        replaces="contextgs_tpu/ops/rasterize/tile_kernel.py:317",
        launches=k1_launches, max_abs_err=k1_res["max_abs"], ms=k1_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= bound_ms else "operations",
        library_ms=None)]
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
