"""The training step of the plain reference, written from ContextGS's
training loop (`train.py`, as the JAX package of this repository states
it), in plain PyTorch:

    loss = (1 - λ_ssim)·L1 + λ_ssim·(1 - SSIM) + 0.01·mean Π scaling
           + λ·bits a parameter + 5e-4·mean sigmoid(mask logit)

over a context-phase render, then Adam (eps 1e-15) with each parameter
group's log-linear learning-rate schedule. `follow` runs the first steps
of a resumed run from the harness's state and returns what the benchmark
compares.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from perfbench.reference import model as md
from perfbench.reference import raster

# the published schedule: (initial, final) learning rate of each group over
# 30,000 steps, log-linear between; `spatial` groups are scaled by the
# scene's extent
MAX_STEPS = 30_000
SCHEDULE = {
    "anchor": (0.0, 0.0, True),
    "offsets": (0.01, 0.0001, True),
    "mask_logit": (0.01, 0.0001, True),
    "anchor_feat": (0.0075, 0.0075, False),
    "hyper_latent": (0.0075, 0.0075, False),
    "scaling_log": (0.007, 0.007, False),
    "rotation": (0.0, 0.0, False),            # frozen
    "opacity_raw": (0.0, 0.0, False),         # frozen
    "mlps.opacity": (0.002, 0.00002, False),
    "mlps.cov": (0.004, 0.004, False),
    "mlps.color": (0.008, 0.00005, False),
    "mlps.grid": (0.005, 0.00001, False),
    "prior": (0.005, 0.00001, False),
}
LAMBDA_DSSIM = 0.2
LAMBDA_RATE = 0.001
SCALING_REG = 0.01
MASK_REG = 5e-4
RATE_SAMPLE = 0.15
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in TF32 (the control) or float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def learning_rate(name: str, step: int, spatial_scale: float) -> float:
    group = next(g for g in sorted(SCHEDULE, key=len, reverse=True)
                 if name == g or name.startswith(g + "."))
    init, final, spatial = SCHEDULE[group]
    if spatial:
        init, final = init * spatial_scale, final * spatial_scale
    if init == 0.0 and final == 0.0:
        return 0.0
    t = min(max(step / MAX_STEPS, 0.0), 1.0)
    return math.exp(math.log(max(init, 1e-30)) * (1 - t)
                    + math.log(max(final, 1e-30)) * t)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [3,H,W] images: 11×11 gaussian window (σ 1.5), zero
    padding, C1 = 0.01², C2 = 0.03², variances clamped at 0."""
    x = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    g = g / g.sum()
    w2 = torch.outer(g, g)
    w2 = (w2 / w2.sum()).to(torch.float32).to(a.device)
    win = w2.expand(3, 1, 11, 11).contiguous()

    def f(img):
        return torch.nn.functional.conv2d(img[None], win, padding=5,
                                          groups=3)[0]

    mu1, mu2 = f(a), f(b)
    s1 = torch.clamp(f(a * a) - mu1 * mu1, min=0.0)
    s2 = torch.clamp(f(b * b) - mu2 * mu2, min=0.0)
    s12 = f(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def param_names(m: dict) -> list:
    return [n for n in m if n in md.ANCHOR_FIELDS
            or n.startswith(("mlps.", "prior."))]


def loss_of(m: dict, model: md.Model, cam: dict, gt, bg, width: int,
            height: int, level_scales, generator) -> torch.Tensor:
    """The context phase's training loss of one view."""
    n = m["anchor"].shape[0]
    anchor_q = md.quantized_anchor(m)
    levels = md.build_levels(anchor_q.detach(), md.kept_anchors(m),
                             model.voxel_size, level_scales, model.level_num)
    vis = raster.visible(anchor_q.detach(),
                         torch.exp(m["scaling_log"])[:, :3].detach(), cam,
                         width, height, valid=m["alive"]) & m["alive"]
    noise = md.draw_noise(generator, n, model, anchor_q.device)
    ctx = md.context(m, model, levels, anchor_q, noise)
    bits = md.rate(m, model, ctx, noise["rate"], RATE_SAMPLE)
    g = md.neural_gaussians(
        m, model, cam["center"], vis, ctx.coded["feat"],
        ctx.coded["scaling"], ctx.coded["offsets"].reshape(n, -1, 3),
        anchor_q, md.offset_mask(m))
    image = raster.rasterize(g.xyz, g.scaling, g.rot, g.color, g.opacity,
                             cam, width, height, bg, valid=g.valid)
    sc = g.scaling
    volume = torch.where(g.valid, sc[:, 0] * sc[:, 1] * sc[:, 2], 0.0)
    alive = m["alive"].to(torch.float32)[:, None]
    mask_mean = ((torch.sigmoid(m["mask_logit"]) * alive).sum()
                 / torch.clamp(alive.sum() * model.n_offsets, min=1))
    return ((1 - LAMBDA_DSSIM) * (image - gt).abs().mean()
            + LAMBDA_DSSIM * (1 - ssim(image, gt))
            + SCALING_REG * volume.sum() / torch.clamp(g.valid.sum(), min=1)
            + LAMBDA_RATE * bits + MASK_REG * mask_mean)


def follow(state: dict, nets: dict, model: md.Model, cameras: list,
           images: np.ndarray, level_scales, spatial_lr_scale: float,
           rng_state: dict, seed: int, start_iteration: int, steps: int,
           device, tf32: bool = False, keep: bool = False) -> dict:
    """{"loss": [per step], "grad": {leaf: norm of its first gradient},
    "change": {leaf: norm of its change after the steps}} of `steps`
    steps resumed at `start_iteration` with fresh Adam moments: the views
    taken in the order a resumed run takes them (a permutation of the
    views from `rng_state`, popped from its end, and again), the noise from
    a generator on `device` seeded with `seed`. With `keep`, also
    "grad_full" and "change_full": the tensors themselves, on the host,
    and "grads_steps": each step's gradient of the networks' leaves."""
    m = {k: v.clone() for k, v in state.items()}
    m.update({k: v.to(device).clone() for k, v in nets.items()})
    names = param_names(m)
    start = {n: m[n].clone() for n in names}
    mom = {n: torch.zeros_like(m[n]) for n in names}
    vel = {n: torch.zeros_like(m[n]) for n in names}
    rng = np.random.default_rng(0)
    rng.bit_generator.state = rng_state
    generator = torch.Generator(device).manual_seed(seed)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    height, width = images.shape[1:3]
    order: list = []
    out = {"loss": [], "grad": {}, "change": {}}
    with precision(tf32):
        for k in range(1, steps + 1):
            it = start_iteration + k
            if not order:
                order = [int(i) for i in rng.permutation(len(cameras))]
            v = order.pop()
            gt = torch.from_numpy(np.ascontiguousarray(
                np.transpose(images[v], (2, 0, 1)))).to(device)
            leaves = {n: m[n].detach().requires_grad_(True) for n in names}
            loss = loss_of({**m, **leaves}, model, cameras[v], gt, bg,
                           width, height, level_scales, generator)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                bc1, bc2 = 1 - ADAM_B1 ** k, 1 - ADAM_B2 ** k
                if keep:
                    out.setdefault("grads_steps", []).append({})
                for n, g in zip(names, grads):
                    g = torch.zeros_like(m[n]) if g is None else g
                    if k == 1:
                        out["grad"][n] = float(torch.linalg.vector_norm(
                            g.double()))
                        if keep:
                            out.setdefault("grad_full", {})[n] = g.cpu()
                    if keep and n.startswith(("mlps.", "prior.")):
                        out["grads_steps"][-1][n] = g.cpu()
                    mom[n] = ADAM_B1 * mom[n] + (1 - ADAM_B1) * g
                    vel[n] = ADAM_B2 * vel[n] + (1 - ADAM_B2) * g * g
                    lr = learning_rate(n, it, spatial_lr_scale)
                    m[n] = m[n] - lr * (mom[n] / bc1) / (
                        torch.sqrt(vel[n] / bc2) + ADAM_EPS)
    out["change"] = {n: float(torch.linalg.vector_norm(
        (m[n] - start[n]).double())) for n in names}
    if keep:
        out["change_full"] = {n: (m[n] - start[n]).cpu() for n in names}
    return out
