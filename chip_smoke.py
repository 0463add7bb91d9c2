#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`contextgs_tpu_torch`) on one NVIDIA
card: the quickest proof that the port builds, serves and trains on the GPU.

    python3 chip_smoke.py

Phases, one JSON object per line; any failed check exits non-zero:

1. device  — the card's name and power limit; K1 and K2 built from the
   sources in the checkout (nvcc, sm_90a, one process each, together).
2. k1_check — K1 against its plain PyTorch version on the card: golden small
   cases (2e-5), then a 1280x720 view of a 20k-anchor decoded scene (max
   2e-4, mean 1e-6: an include decision at T·(1-α) ≈ 1e-4 may flip between
   the plain version's log-space prefix and the kernel's sequential product,
   and each flip moves a pixel by at most α·T ≤ 1e-4).
   k2_check — K2 against its plain version (autograd through the plain
   blend) on the golden cases and the 20k view, with random cotangents and a
   nonzero dL/dT_final: every component of d_rows inside the envelope of the
   plain gradients at T_EPS·(1±2e-4), widened by 1.5e-3 of that component's
   largest |grad| (the JAX package's Pallas-versus-oracle tolerance, the size
   of rounding between a sequential product and a log-space prefix).
3. serve — the main path of serving at full width: a decoded scene of
   ModelConfig() width (feat_dim 50, 10 offsets) and 100k anchors, built with
   the recipe of scripts/fps_bench.py from a seed, rendered by
   make_decoded_renderer → render_set over a full orbit of 32 views at
   1280x720 (the first 5 are render_set's warm-up) and scored by
   evaluate_images against a seeded target. K1's launch count is set to 0
   just before and read just after, and must equal the number of views; K1's
   inputs of the last view are kept from this run. Then a second pass over
   the orbit with CUDA events around the renderer's module-level calls (the
   stage split), K1 checked, timed and bounded on the kept inputs, the small
   CPU-vs-card check, and render(phase="plain") from init_scene_model over a
   seeded 100k-point cloud.
4. ssim_grad — the SSIM gradient at 1280x720 on the card against float64 on
   the CPU (1e-5 relative; cuDNN's TF32 would give about 1e-3, printed too).
5. train — the main path of training at full width: train() from
   init_scene_model over the serve scene's 100k anchor positions, the 32
   serve renders as targets, 60 steps at 1280x720 (1-30 plain, 31-60 noise,
   densify at 20, 30 and 40). K1's and K2's counts are set to 0 just before
   and read just after and must equal the steps; the losses are finite and
   fall; CUDA events split each step into forward render, loss, backward,
   Adam, statistics and densify. K2 is checked again on the last step's
   inputs; train_profile: torch.profiler over 3 more steps (device time by
   kernel, the device's busy share). Then train_small_cpu_vs_card: 5 plain
   steps of a small scene
   from one state on the CPU and on the card (losses 1e-3 relative:
   atomics and reduction order differ), and k2_bound: K2 timed and bounded
   on the last step's inputs.
6. the `kernels` line, then the card line from nvidia-smi, then the result.
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
# float32 operations K2 spends on a pair up to last_contrib
# (csrc/blend_backward.cu): dx, dy and power (11) for every pair; op·e and
# the 0.99 clamp (2) where power <= 0 (the exp on the SFU); for a blended
# pair the colour dot product, the prefix, 1 - α and its reciprocal, dL/dα,
# the colour gradients and the T update (20), the gradients of opacity, mean
# and conic (19), and the 9 additions that sum the pixels' values (9).
OPS_K2 = dict(bwd_evaluated=11, bwd_exp=2, bwd_blended=48)
ENVELOPE = 1.5e-3            # K2 against the plain envelope, of max |grad|
TRAIN_STEPS = 60
# the training step's module-level calls the train split times
TRAIN_STAGES = ("forward", "loss", "backward", "adam", "stats", "densify")
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


def roofline(n_bytes, n_ops, n_exp):
    """The least time for the work, and which term sets it: the bytes at
    the HBM rate, the float32 operations at the CUDA cores' rate, the exps
    at the special-function units' rate."""
    terms = dict(bytes=n_bytes / PEAK_HBM_BYTES * 1e3,
                 fp32=n_ops / PEAK_FP32_FLOPS * 1e3,
                 exp=n_exp / SFU_EXP_PER_S * 1e3)
    term = max(terms, key=terms.get)
    return dict(bytes_ms=terms["bytes"], fp32_ops_ms=terms["fp32"],
                exp_ms=terms["exp"], bound_ms=terms[term], bound_by=term)


def cotangents(width, height, seed, dev):
    gen = torch.Generator(dev).manual_seed(seed)
    return (torch.randn((3, height, width), generator=gen, device=dev),
            torch.randn((height, width), generator=gen, device=dev))


def compare_k2(rows, ids, bounds, width, height, d_rgb, d_ft, t_eps=1e-4,
               delta=2e-4):
    """K2 against its plain version on the same card inputs: the largest
    distance outside the envelope of the plain gradients at t_eps·(1±δ), and
    the share of rows off the plain gradient at t_eps by more than 1e-4, both
    in units of each component's largest |grad|."""
    from contextgs_tpu_torch.ops.rasterize import reference, tile_kernel

    rgb, ft, last = tile_kernel.blend_forward(rows, ids, bounds, width,
                                              height, t_eps)
    got = tile_kernel.blend_backward(rows, ids, bounds, rgb, ft, last, d_rgb,
                                     d_ft, width, height, t_eps)
    torch.cuda.reset_peak_memory_stats()
    plain = torch.stack([reference.blend_tiles_backward_reference(
        rows, ids, bounds, rgb, ft, last, d_rgb, d_ft, width, height,
        t_eps * f) for f in (1 - delta, 1.0, 1 + delta)])
    torch.cuda.synchronize()
    scale = plain[1].abs().amax(0).clamp_min(1e-30)
    outside = torch.maximum((plain.amin(0) - got) / scale,
                            (got - plain.amax(0)) / scale).clamp_min(0)
    off = ((got - plain[1]).abs() / scale).amax(1)
    return dict(envelope_err=float(outside.max()),
                rows_off_1e4=float((off > 1e-4).float().mean()),
                max_abs=float((got - plain[1]).abs().max()),
                max_grad=float(plain[1].abs().max()),
                finite=bool(torch.isfinite(got).all()),
                plain_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def check_k2(case, res):
    emit(phase="k2_check", case=case, **res)
    check(res["finite"] and res["envelope_err"] <= ENVELOPE,
          f"K2 {case} inside the plain envelope")


def ssim_grad(dev):
    """The SSIM gradient at 1280x720, card float32 against CPU float64; and
    what a backward in cuDNN's TF32 (the filter switched off TF32 for its
    forward only) gives, for scale."""
    from contextgs_tpu_torch.ops import ssim as tssim

    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)

    def grad(dtype, device):
        x = torch.from_numpy(a).to(device, dtype).requires_grad_(True)
        y = torch.from_numpy(b).to(device, dtype)
        return torch.autograd.grad(tssim.ssim(x, y), x)[0].double().cpu()

    want = grad(torch.float64, "cpu")
    got = grad(torch.float32, dev)

    def forward_only_fp32(img, window):
        c, k = img.shape[0], window.shape[0]
        allow = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return torch.nn.functional.conv2d(
                img[None], window[None, None].expand(c, 1, k, k),
                padding=k // 2, groups=c)[0]
        finally:
            torch.backends.cudnn.allow_tf32 = allow

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with wrapped(tssim, "_filter2d", lambda fn: forward_only_fp32):
            got_tf32 = grad(torch.float32, dev)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = float(want.abs().max())
    return dict(rel_err=float((got - want).abs().max()) / scale,
                rel_err_tf32_backward=float((got_tf32 - want).abs().max())
                / scale)


def train_scene(dec, renders, cams):
    """The serve scene's anchor positions and its orbit renders as a
    training scene (orbit radius 4: the nerf++ radius 1.1·4)."""
    from contextgs_tpu_torch.scene.dataset_readers import SceneInfo

    pts = dec.anchor.double().cpu().numpy()
    for cam, img in zip(cams, renders):
        cam.image = np.clip(img.permute(1, 2, 0).cpu().numpy(), 0, 1)
    return SceneInfo(points=pts, colors=np.zeros_like(pts),
                     normals=np.zeros_like(pts), train_cameras=cams,
                     test_cameras=[], radius=4.4)


def train_split_targets():
    """(module, name, stage) of the training step's module-level calls: the
    names train/step.py and train/loop.py look up at call time."""
    import contextgs_tpu_torch.models.densify as tdensify
    import contextgs_tpu_torch.train.step as tstep

    return [(tstep, "render", "forward"), (tstep, "l1_loss", "loss"),
            (tstep, "ssim", "loss"), (torch.autograd, "grad", "backward"),
            (tstep, "adam_update", "adam"),
            (tdensify, "accumulate_stats", "stats"),
            (tdensify, "adjust_anchors", "densify")]


def train_small_cpu_vs_card(dev):
    """5 plain steps of a small scene from one state on the CPU and on the
    card; the loss sequences."""
    from contextgs_tpu_torch.config import ModelConfig, TrainConfig
    from contextgs_tpu_torch.models import state as tst
    from contextgs_tpu_torch.train.optim import init_adam
    from contextgs_tpu_torch.train.step import make_train_step

    cfg = TrainConfig(model=ModelConfig())
    w, h = 128, 96
    cams = orbit_cameras(4, w, h, 5)
    pts = np.random.default_rng(5).uniform(-2, 2, (2_000, 3))
    losses = {}
    for device in ("cpu", dev):
        model, _ = tst.init_scene_model(
            pts, cfg.model, generator=torch.Generator().manual_seed(5),
            device=device)
        p, b, adam = model.params, model.buffers, init_adam(model.params)
        step = make_train_step(cfg, w, h, "plain", 4.4)
        seq = []
        for it in range(1, 6):
            cam = cams[(it - 1) % len(cams)]
            gt = torch.from_numpy(np.ascontiguousarray(
                cam.image.transpose(2, 0, 1))).to(device)
            p, b, adam, m = step(p, b, adam, cam.as_device_dict(), gt,
                                 torch.zeros(3, device=device), it, True)
            seq.append(float(m.loss))
        losses[str(device)] = seq
    return losses["cpu"], losses[str(dev)]


def profile_train_steps(ts, cfg, scene, dev, step_ms, n=3):
    """torch.profiler over n noise-phase steps from the trained state (one
    warm-up step first): kernel time per step, the busiest kernels and host
    operators, and the device's busy share: kernel time per step over
    `step_ms`, the unprofiled median step (the profiler slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from contextgs_tpu_torch.train.step import make_train_step

    step = make_train_step(cfg, W, H, "noise", ts.spatial_lr_scale)
    bg = torch.zeros(3, device=dev)
    state = (ts.model.params, ts.model.buffers, ts.adam)
    cams = scene.train_cameras

    def run(i):
        cam = cams[i % len(cams)]
        gt = torch.from_numpy(np.ascontiguousarray(
            cam.image.transpose(2, 0, 1))).to(dev)
        return step(*state, cam.as_device_dict(), gt, bg,
                    TRAIN_STEPS + 1 + i, True, ts.generator)[:3]

    state = run(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1, n + 1):
            state = run(i)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(device_us(e) for e in kernels) / 1e3 / n

    def top(items, key, k):
        return [dict(name=e.key[:70], ms_per_step=key(e) / 1e3 / n,
                     calls_per_step=e.count / n)
                for e in sorted(items, key=key, reverse=True)[:k]]

    return dict(steps=n, profiled_wall_ms_per_step=wall_ms,
                kernel_ms_per_step=device_ms,
                kernels_per_step=sum(e.count for e in kernels) / n,
                device_busy_share=device_ms / step_ms,
                top_kernels=top(kernels, device_us, 10),
                top_host_self=top(events, lambda e: e.self_cpu_time_total, 8))


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
    cuda_build.build(tile_kernel.SOURCES)
    build_s = time.perf_counter() - t0

    def ptxas(stem):
        out = cuda_build.build_log.get(stem, {}).get("ptxas", "")
        return [ln.strip() for ln in out.splitlines() if "Used" in ln]

    emit(phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, k1_ptxas=ptxas("blend_forward"),
         k2_ptxas=ptxas("blend_backward"))

    # ---- 2. K1 against its plain version ----
    for name, (rows, ids, bounds, w, h) in golden_cases(dev):
        res = compare_k1(rows, ids, bounds, w, h)
        emit(phase="k1_check", case=name, **res)
        check(res["finite"] and res["max_abs"] <= 2e-5, f"K1 golden {name}")
        check(res["last_contrib_mismatch"] == 0, f"K1 last_contrib {name}")
    got_g = tile_kernel.blend_forward(*next(iter(
        c for n, c in golden_cases(dev) if n == "chunk_boundary")))[0][1]
    check(float(got_g.abs().max()) == 0.0, "chunk-boundary green must be 0")
    for i, (name, (rows, ids, bounds, w, h)) in enumerate(golden_cases(dev)):
        check_k2(name, compare_k2(rows, ids, bounds, w, h,
                                  *cotangents(w, h, 30 + i, dev)))

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
    check_k2("decoded_20k_1280x720",
             compare_k2(rows, ids, bounds, W, H, *cotangents(W, H, 40, dev)))
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
    k1_bound = roofline(n_bytes, n_ops, pairs["exp"])
    emit(phase="k1_bound", pairs=pairs, pairs_listed=256 * int(ids.numel()),
         rows_read=rows_read, bytes=n_bytes, fp32_ops=n_ops, **k1_bound,
         k1_ms=k1_ms, plain_ms=plain_ms,
         share_of_bound=k1_bound["bound_ms"] / k1_ms)

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

    # ---- 4. the SSIM gradient in full float32 ----
    res = ssim_grad(dev)
    emit(phase="ssim_grad", width=W, height=H, **res)
    check(res["rel_err"] <= 1e-5, "SSIM gradient on the card vs float64")

    # ---- 5. the main path of training ----
    import contextgs_tpu_torch.train.loop as tloop

    scene = train_scene(dec, renders, orbit_cameras(N_VIEWS, W, H, 1))
    del render, renders, split_view_ms, k1_kept, rows, ids, bounds
    tcfg = TrainConfig(model=ModelConfig(), opt=OptimizationConfig(
        iterations=TRAIN_STEPS, noise_from=30, context_from=TRAIN_STEPS,
        start_stat=5, update_from=10, update_interval=10, update_until=50),
        test_iterations=(), save_iterations=(), log_every=10 ** 9)
    log, losses, step_ms, k2_kept = [], [], [], {}
    t_prev = [time.perf_counter()]

    def mark_step(it, ts, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - t_prev[0]) * 1e3)
        t_prev[0] = now
        losses.append(metrics.loss)
        log.append(("step", it, None, None))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for module, name, stage in train_split_targets():
            summary = ((lambda r: (r.n_grown, r.n_pruned))
                       if stage == "densify" else lambda out: None)
            stack.enter_context(wrapped(module, name,
                                        timed_call(stage, log, summary)))
        stack.enter_context(wrapped(trz, "blend_backward",
                                    keep_args(k2_kept)))
        tile_kernel.launches = tile_kernel.backward_launches = 0
        t_prev[0] = time.perf_counter()
        ts = tloop.train(tcfg, scene, callback=mark_step)
        torch.cuda.synchronize()
        train_k1 = tile_kernel.launches
        train_k2 = tile_kernel.backward_launches
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    split = {f"{st}_ms": 0.0 for st in TRAIN_STAGES}
    densified, it = [], 0
    for name, start, end, out in log:
        if name == "step":
            it = start
        elif name == "densify":
            densified.append(dict(grown=int(out[0]), pruned=int(out[1])))
        if name != "step" and it >= 5:          # steps 6-60
            split[f"{name}_ms"] += (start.elapsed_time(end)
                                    / (TRAIN_STEPS - 5))
    timed_ms = step_ms[5:]
    split["step_ms_median"] = float(np.median(timed_ms))
    split["other_ms"] = float(np.mean(timed_ms)) - sum(
        split[f"{st}_ms"] for st in TRAIN_STAGES)
    emit(phase="train", steps=TRAIN_STEPS, width=W, height=H,
         anchors_init=int(dec.anchor.shape[0]),
         anchors_final=int(ts.model.buffers.alive.sum()),
         capacity=int(ts.model.buffers.alive.shape[0]),
         k1_launches=train_k1, k2_launches=train_k2,
         ms_per_step_median=split["step_ms_median"],
         ms_per_step_min=min(timed_ms), ms_per_step_max=max(timed_ms),
         split=split, densify=densified, peak_mem_gib=train_peak,
         loss_first5=losses[:5], loss_last5=losses[-5:])
    check(train_k2 == TRAIN_STEPS, "K2 launches on the training path != steps")
    check(train_k1 == TRAIN_STEPS, "K1 launches on the training path != steps")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          "training losses finite")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), "training loss falls")
    check(len(densified) == 3, "densify ran at steps 20, 30 and 40")
    emit(phase="train_profile", **profile_train_steps(
        ts, tcfg, scene, dev, split["step_ms_median"]))
    del ts, scene, dec, log

    kept = k2_kept["args"]
    k2_res = compare_k2(*kept[:3], W, H, *kept[6:8], kept[10])
    check_k2("train_last_step_1280x720", k2_res)

    cpu_losses, card_losses = train_small_cpu_vs_card(dev)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    emit(phase="train_small_cpu_vs_card", cpu=cpu_losses, card=card_losses,
         max_rel=rel)
    check(rel <= 1e-3, "small training run CPU vs card")

    # K2 on the main path's last inputs: time, bound
    k2_ms = cuda_ms(lambda: tile_kernel.blend_backward(*kept), 20)
    k2_plain_ms = cuda_ms(
        lambda: reference.blend_tiles_backward_reference(*kept), 3)
    rows, ids, bounds = kept[:3]
    pairs = reference.blend_tiles_reference(rows, ids, bounds, W, H, W // 16,
                                            t_eps=kept[10],
                                            count_pairs=True)[3]
    # bytes: the rows of gaussians with tile instances, ids and bounds,
    # K1's three outputs and the two cotangents read once, d_rows written
    rows_read = int(torch.unique(ids).numel())
    n_bytes = (rows_read * rows.shape[1] * 4 + ids.numel() * 4
               + bounds.numel() * 4 + H * W * (3 + 1 + 1 + 3 + 1) * 4
               + rows.numel() * 4)
    n_ops = sum(OPS_K2[k] * pairs[k] for k in OPS_K2)
    k2_bound = roofline(n_bytes, n_ops, pairs["bwd_exp"])
    emit(phase="k2_bound", pairs=pairs, rows_read=rows_read,
         n_gauss=int(rows.shape[0]), n_instances=int(ids.numel()),
         bytes=n_bytes, fp32_ops=n_ops, **k2_bound,
         atomics=9 * pairs["bwd_warp_blended"], k2_ms=k2_ms,
         plain_ms=k2_plain_ms, share_of_bound=k2_bound["bound_ms"] / k2_ms)

    # ---- 6. kernels line, card line, result ----
    def contract_label(bound):        # the kernels line says bytes or ops
        return "bytes" if bound["bound_by"] == "bytes" else "operations"

    kernels = [
        dict(name="blend_forward", route="cuda",
             source="contextgs_tpu_torch/ops/rasterize/csrc/blend_forward.cu",
             replaces="contextgs_tpu/ops/rasterize/tile_kernel.py:317",
             launches=k1_launches + train_k1,
             launches_by_path=dict(serve=k1_launches, train=train_k1),
             max_abs_err=k1_res["max_abs"], ms=k1_ms, plain_ms=plain_ms,
             bound_ms=k1_bound["bound_ms"],
             bound_by=contract_label(k1_bound),
             bound_term=k1_bound["bound_by"], library_ms=None),
        dict(name="blend_backward", route="cuda",
             source="contextgs_tpu_torch/ops/rasterize/csrc/blend_backward.cu",
             replaces="contextgs_tpu/ops/rasterize/tile_kernel.py:548",
             launches=train_k2, launches_by_path=dict(train=train_k2),
             max_abs_err=k2_res["max_abs"], ms=k2_ms, plain_ms=k2_plain_ms,
             bound_ms=k2_bound["bound_ms"],
             bound_by=contract_label(k2_bound),
             bound_term=k2_bound["bound_by"], library_ms=None)]
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
