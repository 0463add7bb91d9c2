"""Evaluation: render camera sets from a decoded scene, compute metrics, write
results.json (port of `contextgs_tpu/evaluation.py`).

Shapes are dynamic, so the reference's instance budget, visible cap and
anchor cap — and the re-jit loop that grows them — have no counterpart: the
visible anchors are compacted by boolean index before the decode, as the
CUDA reference does, and the image equals the reference's uncapped one.
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from contextgs_tpu_torch.compression.codec import DecodedScene
from contextgs_tpu_torch.config import TrainConfig
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.models.decode import decode_neural_gaussians
from contextgs_tpu_torch.models.renderer import camera_tensors
from contextgs_tpu_torch.ops import rasterize as rz
from contextgs_tpu_torch.ops.lpips import (load_weights as load_lpips_weights,
                                           lpips as lpips_fn)
from contextgs_tpu_torch.ops.ssim import psnr as psnr_fn, ssim as ssim_fn
from contextgs_tpu_torch.utils import png, trace

LPIPS_SKIPPED = ("no VGG weights: set CONTEXTGS_LPIPS_WEIGHTS to an exported "
                 ".npz (see ops/lpips.py)")


class _DecodedParams(NamedTuple):
    """Minimal params view for decoded-scene rendering (mlps only)."""

    mlps: object


def make_decoded_renderer(dec: DecodedScene, cfg: TrainConfig, width: int,
                          height: int, device=None):
    """Renderer over a decoded (compacted) scene — the reference's
    decoded_version path. Returns `render(cam, bg) -> image [3,H,W]` on
    `device` (default: the CUDA card); `dec.mlps` is moved there in place."""
    dev = resolve_device(device)
    mcfg = cfg.model
    K = mcfg.n_offsets

    def put(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    anchor, feat, scaling = put(dec.anchor), put(dec.feat), put(dec.scaling)
    offsets, masks = put(dec.offsets), put(dec.masks)
    params = _DecodedParams(mlps=dec.mlps.to(dev))

    @torch.no_grad()
    def render(cam: dict, bg) -> torch.Tensor:
        with trace.span("serve/view"):
            cam = camera_tensors(cam, dev)
            with trace.span("render/cull"):
                vis = rz.visible_filter(anchor, scaling[:, :3],
                                        cam["world_view"], cam["full_proj"],
                                        cam["tanfovx"], cam["tanfovy"],
                                        width, height)
            with trace.sync("view.visible"):
                idx = torch.nonzero(vis).squeeze(1)
            trace.count("visible_anchors", idx.numel())
            with trace.span("render/decode"):
                ng = decode_neural_gaussians(
                    params, None, mcfg, cam["camera_center"], vis[idx],
                    feat=feat[idx], grid_scaling=scaling[idx],
                    grid_offsets=offsets[idx].reshape(-1, K, 3),
                    anchor=anchor[idx], binary_mask=masks[idx])
            out = rz.rasterize(ng.xyz, ng.scaling, ng.rot, ng.color,
                               ng.opacity, world_view=cam["world_view"],
                               full_proj=cam["full_proj"],
                               tanfovx=cam["tanfovx"],
                               tanfovy=cam["tanfovy"], width=width,
                               height=height, bg=put(bg),
                               valid=ng.gauss_valid)
            return out.image

    render.device = dev
    return render


def evaluate_images(renders: list, gts: list, device=None) -> dict:
    """PSNR/SSIM/LPIPS over [3,H,W] images (tensors or numpy) on `device`.
    LPIPS needs VGG weights (CONTEXTGS_LPIPS_WEIGHTS, see ops/lpips.py);
    without them it is None and `LPIPS_skipped` says why."""
    dev = resolve_device(device)
    lw = load_lpips_weights(device=dev)
    psnrs, ssims, lpipss = [], [], []
    for r, g in zip(renders, gts):
        r = torch.clamp(torch.as_tensor(r, device=dev), 0, 1)
        g = torch.as_tensor(g, device=dev)
        psnrs.append(float(psnr_fn(r, g)))
        ssims.append(float(ssim_fn(r, g)))
        if lw is not None:
            lpipss.append(float(lpips_fn(lw, r, g)))
    out = dict(PSNR=float(np.mean(psnrs)), SSIM=float(np.mean(ssims)),
               per_view=dict(PSNR=psnrs, SSIM=ssims, LPIPS=lpipss),
               LPIPS=float(np.mean(lpipss)) if lpipss else None)
    if lw is None:
        out["LPIPS_skipped"] = LPIPS_SKIPPED
    return out


def render_set(render_fn, cameras, bg, out_dir: Optional[str] = None,
               save_images: bool = True,
               view_ms: Optional[list] = None) -> tuple[list, list, float]:
    """Render all cameras with a `make_decoded_renderer` renderer; returns
    (renders, gts, fps) with renders as tensors on the renderer's device and
    gts as [3,H,W] numpy arrays.

    Every view is timed, with CUDA events on a CUDA renderer and the host
    clock on the CPU; as in the reference, the first 5 views are a warm-up
    left out of the FPS when there are more than 5. Each view's time in ms,
    warm-up included, is appended to `view_ms` when it is given."""
    renders, gts = [], []
    times = view_ms if view_ms is not None else []
    on_cuda = render_fn.device.type == "cuda"
    for cam in cameras:
        cd = cam.as_device_dict()
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            img = render_fn(cd, bg)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            img = render_fn(cd, bg)
            ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        renders.append(img)
        gts.append(np.transpose(cam.image, (2, 0, 1)))
    timed = times[5:] if len(times) > 5 else times
    fps = len(timed) / max(sum(timed) / 1e3, 1e-9)
    if out_dir and save_images:
        for sub in ("renders", "gt", "errors"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

        def save(x, sub, i):
            # truncation to uint8, as the reference's astype
            png.write_png(os.path.join(out_dir, sub, f"{i:05d}.png"),
                          (np.clip(x, 0, 1).transpose(1, 2, 0) * 255)
                          .astype(np.uint8))

        for i, (r, g) in enumerate(zip(renders, gts)):
            r = r.cpu().numpy()
            save(r, "renders", i)
            save(g, "gt", i)
            save(np.abs(r - g), "errors", i)
    return renders, gts, fps


def write_results(model_path: str, name: str, metrics: dict, size_bits=None,
                  fps: float = 0.0) -> None:
    os.makedirs(model_path, exist_ok=True)
    results_file = os.path.join(model_path, "results.json")
    existing = {}
    if os.path.exists(results_file):
        with open(results_file) as f:
            existing = json.load(f)
    entry = {"PSNR": metrics["PSNR"], "SSIM": metrics["SSIM"],
             "LPIPS": metrics.get("LPIPS"), "FPS": fps}
    if metrics.get("LPIPS_skipped"):
        entry["LPIPS_skipped"] = metrics["LPIPS_skipped"]
    if size_bits is not None:
        entry["size_MB"] = size_bits.get("total", 0) / 8 / 1024 / 1024
        entry["size_breakdown_bits"] = {
            k: v for k, v in size_bits.items() if isinstance(v, (int, float))}
    existing[name] = entry
    with open(results_file, "w") as f:
        json.dump(existing, f, indent=2)
    with open(os.path.join(model_path, "per_view.json"), "w") as f:
        json.dump({name: metrics.get("per_view", {})}, f, indent=2)
