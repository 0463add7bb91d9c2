"""The ContextGS scene model of the plain reference, written from the model's
semantics (ContextGS's `scene/gaussian_model.py`, `utils/encodings.py`,
`utils/entropy_models.py` and `gaussian_renderer/__init__.py`, as the JAX
package of this repository states them), in plain PyTorch.

A model is a flat dict of tensors by leaf name: the anchor fields
(`anchor`, `anchor_feat`, `hyper_latent`, `offsets`, `mask_logit`,
`scaling_log`, `rotation`, `opacity_raw`), the MLPs' `mlps.<net>.<l1|l2>.
<weight|bias>` (weight [out, in]) and the factorized prior's
`prior.<matrices|biases|factors>.<i>`; the buffers (`alive`, `bound_min`,
`bound_max`) sit beside them in the same dict.

Every context level runs its grid MLP over the whole anchor pool, and the
level's own rows are merged in with `where`: the plain formulation, with
no per-level gathers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

ANCHOR_BITS = 16
Q_ANCHOR = 1.0 / (2 ** ANCHOR_BITS - 1)
CLAMP_STEPS = 15_000          # symbols are clamped to ±15000·Q
LIKELIHOOD_BOUND = 1e-6
MASK_THRESHOLD = 0.01
PRIOR_FILTERS = (3, 3, 3, 3)
PRIOR_INIT_SCALE = 10.0
ANCHOR_FIELDS = ("anchor", "anchor_feat", "hyper_latent", "offsets",
                 "mask_logit", "scaling_log", "rotation", "opacity_raw")


@dataclass(frozen=True)
class Model:
    """The sizes of a configuration file that the model reads."""

    feat_dim: int
    n_offsets: int
    voxel_size: float
    hyper_divisor: int
    level_num: int
    target_ratio: float
    q_feat: float
    q_scaling: float
    q_offsets: float

    @classmethod
    def of(cls, config: dict) -> "Model":
        return cls(**{k: config[k] for k in cls.__dataclass_fields__})

    @property
    def hyper_dim(self) -> int:
        return self.feat_dim // self.hyper_divisor

    @property
    def grid_out(self) -> int:
        return (self.feat_dim + 6 + 3 * self.n_offsets) * 2 + 3

    def net_shapes(self) -> dict:
        """(in, hidden, out) of every MLP: the opacity, covariance and
        colour decoders on [feat, view direction, distance], and one grid
        MLP a level, the coarsest on [anchor, hyper latent], the others on
        [parent's anchor, feature, scaling; hyper latent]."""
        f, k, h = self.feat_dim, self.n_offsets, self.hyper_dim
        out = dict(opacity=(f + 4, f, k), cov=(f + 4, f, 7 * k),
                   color=(f + 4, f, 3 * k))
        for i in range(self.level_num):
            d_in = h + 3 if i == self.level_num - 1 else 3 + f + 6 + h
            out[f"grid.{i}"] = (d_in, 2 * f, self.grid_out)
        return out


def init_nets(model: Model, gen: torch.Generator) -> dict:
    """Seeded networks on the host: each MLP's layers U(±1/√fan_in) (the
    default of a linear layer), drawn weight then bias, layer by layer in
    the order of `net_shapes`; the factorized prior as compressai's
    EntropyBottleneck starts it (matrices log(expm1(1/s/f)), biases
    U(-0.5, 0.5), factors zero)."""
    out = {}
    for net, (d_in, d_hid, d_out) in model.net_shapes().items():
        for layer, (a, b) in (("l1", (d_in, d_hid)), ("l2", (d_hid, d_out))):
            bound = 1.0 / math.sqrt(a)
            for part, shape in (("weight", (b, a)), ("bias", (b,))):
                out[f"mlps.{net}.{layer}.{part}"] = (
                    torch.rand(shape, generator=gen) * 2 - 1) * bound
    dims = (1,) + PRIOR_FILTERS + (1,)
    scale = PRIOR_INIT_SCALE ** (1.0 / (len(PRIOR_FILTERS) + 1))
    c = model.hyper_dim
    for i in range(len(dims) - 1):
        out[f"prior.matrices.{i}"] = torch.full(
            (c, dims[i + 1], dims[i]),
            math.log(math.expm1(1.0 / scale / dims[i + 1])))
        out[f"prior.biases.{i}"] = torch.rand((c, dims[i + 1], 1),
                                              generator=gen) - 0.5
        if i < len(PRIOR_FILTERS):
            out[f"prior.factors.{i}"] = torch.zeros((c, dims[i + 1], 1))
    return out


def mlp(m: dict, net: str, x: torch.Tensor) -> torch.Tensor:
    """Linear, ReLU, Linear."""
    h = torch.relu(x @ m[f"mlps.{net}.l1.weight"].T + m[f"mlps.{net}.l1.bias"])
    return h @ m[f"mlps.{net}.l2.weight"].T + m[f"mlps.{net}.l2.bias"]


# -- quantization --------------------------------------------------------

def straight_through(x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """`value` forward, identity gradient into `x`."""
    return x + (value - x).detach()


def anchor_interval(bound_min, bound_max):
    return (bound_max - bound_min) * Q_ANCHOR + 1e-6


def quantized_anchor(m: dict) -> torch.Tensor:
    """The anchors on their 16-bit grid between the bounds, straight
    through."""
    bmin, bmax = m["bound_min"], m["bound_max"]
    interval = anchor_interval(bmin, bmax)
    codes = torch.clamp(torch.floor((m["anchor"] - bmin) / interval), 0,
                        2 ** ANCHOR_BITS - 1)
    return straight_through(m["anchor"], codes * interval + bmin)


def offset_mask(m: dict) -> torch.Tensor:
    """[N,K] hard mask sigmoid(logit) > 0.01, with the sigmoid's gradient."""
    s = torch.sigmoid(m["mask_logit"])
    return straight_through(s, (s > MASK_THRESHOLD).to(s.dtype))


def kept_anchors(m: dict) -> torch.Tensor:
    """[N] bool: alive with at least one offset on."""
    return (offset_mask(m).detach().sum(1) > 0) & m["alive"]


def rounded_to_step(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """round(x/Q)·Q after the ±15000·Q clamp, straight through."""
    x = torch.minimum(torch.maximum(x, (-CLAMP_STEPS * q).detach()),
                      (CLAMP_STEPS * q).detach())
    return straight_through(x, torch.round(x / q) * q)


# -- entropy models ------------------------------------------------------

class _LowBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x ≥ bound or it pushes x
    up."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=LIKELIHOOD_BOUND)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= LIKELIHOOD_BOUND) | (g < 0), g, 0.0)


def _phi(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gaussian_bits(x, mean, scale, q, x_mean=None):
    """Bits of x under N(mean, scale) over its Q-wide bin; with `x_mean`,
    x is first clamped to x_mean ± 15000·Q."""
    if x_mean is not None:
        lo = (x_mean - CLAMP_STEPS * q).detach()
        hi = (x_mean + CLAMP_STEPS * q).detach()
        x = torch.minimum(torch.maximum(x, lo), hi)
    scale = torch.clamp(scale, min=1e-9)
    p = torch.abs(_phi((x + 0.5 * q - mean) / scale)
                  - _phi((x - 0.5 * q - mean) / scale))
    return -torch.log(_LowBound.apply(p)) / math.log(2.0)


def _prior_logits(m: dict, x: torch.Tensor) -> torch.Tensor:
    """x [C,1,N] → the prior's cumulative logits [C,1,N]."""
    i = 0
    while f"prior.matrices.{i}" in m:
        x = (torch.nn.functional.softplus(m[f"prior.matrices.{i}"]) @ x
             + m[f"prior.biases.{i}"])
        if f"prior.factors.{i}" in m:
            x = x + torch.tanh(m[f"prior.factors.{i}"]) * torch.tanh(x)
        i += 1
    return x


def prior_likelihood(m: dict, y: torch.Tensor) -> torch.Tensor:
    """Likelihood [N,C] of y [N,C] over unit bins under the factorized
    prior."""
    yt = y.T[:, None, :]
    lower = _prior_logits(m, yt - 0.5)
    upper = _prior_logits(m, yt + 0.5)
    sign = -torch.sign(lower + upper).detach()
    p = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    return _LowBound.apply(p[:, 0, :].T)


# -- the anchor hierarchy ------------------------------------------------

class Levels(NamedTuple):
    level: torch.Tensor        # [N] the coarsest level an anchor reaches
    parent: torch.Tensor       # [N] its context source one level coarser


def build_levels(anchors: torch.Tensor, members: torch.Tensor,
                 voxel_size: float, level_scales, level_num: int) -> Levels:
    """Level i's members are the first occupants (least index) of the
    voxels, at scale voxel_size·level_scales[i-1], of level i-1's members;
    a member that is not one has that occupant as its parent. Only
    `members` take part; the others stay at level 0, their own parents."""
    n = anchors.shape[0]
    dev = anchors.device
    level = torch.zeros(n, dtype=torch.int64, device=dev)
    parent = torch.arange(n, device=dev)
    idx = torch.nonzero(members).squeeze(1)
    for i in range(1, level_num):
        scale = torch.tensor(voxel_size * float(level_scales[i - 1]),
                             dtype=anchors.dtype, device=dev)
        keys = torch.round(anchors[idx] / scale).to(torch.int64)
        _, group = torch.unique(keys, dim=0, return_inverse=True)
        first = torch.full((int(group.max()) + 1 if idx.numel() else 0,), n,
                           dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, group, idx, "amin")
        occupant = first[group]
        rep = occupant == idx
        parent[idx[~rep]] = occupant[~rep]
        idx = idx[rep]
        level[idx] = i
    return Levels(level, parent)


def find_level_scales(anchors: np.ndarray, voxel_size: float,
                      bound_min: np.ndarray, bound_max: np.ndarray,
                      target_ratio: float, level_num: int) -> list:
    """Each level's voxel scale: a bisection until the share of occupied
    voxels of the level below is within 0.01 of `target_ratio`."""
    upper = float(((bound_max - bound_min) / voxel_size).max())
    lower = 1.0
    pts = np.asarray(anchors, dtype=np.float64)
    scales = []
    for _ in range(level_num - 1):
        hi, lo = upper, lower
        while True:
            scale = (hi + lo) / 2
            uniq = np.unique(np.round(pts / voxel_size / scale), axis=0) \
                * voxel_size * scale
            ratio = uniq.shape[0] / pts.shape[0]
            if abs(ratio - target_ratio) < 0.01 or abs(hi - lo) < 1:
                break
            if ratio < target_ratio:
                hi = scale
            else:
                lo = scale
        pts, lower = uniq, scale
        scales.append(float(scale))
    return scales


# -- the context model ---------------------------------------------------

STREAMS = ("feat", "scaling", "offsets")


class Entropy(NamedTuple):
    """Per-anchor μ, σ and Q of each stream: dicts by stream name."""
    mean: dict
    scale: dict
    q: dict


def stream_widths(model: Model) -> dict:
    return dict(feat=model.feat_dim, scaling=6, offsets=3 * model.n_offsets)


def predict(m: dict, model: Model, level: int, x: torch.Tensor) -> Entropy:
    """Grid MLP `level` on x → μ, σ and Q = max(Q₀·(1 + tanh(·)), 1e-9)."""
    w = stream_widths(model)
    out = mlp(m, f"grid.{level}", x)
    mean, scale, q, at = {}, {}, {}, 0
    for s in STREAMS:
        mean[s] = out[:, at:at + w[s]]
        scale[s] = out[:, at + w[s]:at + 2 * w[s]]
        at += 2 * w[s]
    base = dict(feat=model.q_feat, scaling=model.q_scaling,
                offsets=model.q_offsets)
    for j, s in enumerate(STREAMS):
        q[s] = torch.clamp(base[s] * (1 + torch.tanh(out[:, at + j:at + j + 1])),
                           min=1e-9)
    return Entropy(mean, scale, q)


def level_input(model: Model, level: int, anchor_q, coded: dict, levels,
                hyper) -> torch.Tensor:
    """The grid MLP's input of every row: its anchor and hyper latent at the
    coarsest level, else its parent's anchor, coded feature and scaling,
    and its own hyper latent."""
    if level == model.level_num - 1:
        return torch.cat([anchor_q, hyper], dim=1)
    p = levels.parent
    return torch.cat([anchor_q[p], coded["feat"][p], coded["scaling"][p],
                      hyper], dim=1)


def draw_noise(generator, n: int, model: Model, device) -> dict:
    """The U[0,1) draws of one training step's context, in the order the
    training step takes them: the hyper latent's [N,Fh], then for each
    level from the coarsest the features', scalings' and offsets' [N,w],
    then the rate subsample's [N]."""
    def u(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=device)

    w = stream_widths(model)
    out = {"hyper": u(n, model.hyper_dim)}
    for i in reversed(range(model.level_num)):
        for s in STREAMS:
            out[(s, i)] = u(n, w[s])
    out["rate"] = u(n)
    return out


class Context(NamedTuple):
    coded: dict            # stream → [N,w] quantized (noisy in training)
    entropy: Entropy       # μ, σ, Q of every row at its own level
    hyper: torch.Tensor    # [N,Fh] noisy or rounded hyper latent
    hyper_likelihood: torch.Tensor


def context(m: dict, model: Model, levels: Levels, anchor_q, noise=None
            ) -> Context:
    """Every anchor's features, scalings and offsets quantized at its own
    level, coarsest first, with μ, σ and Q from the level's grid MLP over
    the already-coded parents: x + (u - 1/2)·Q with `noise` (training),
    round(x/Q)·Q detached without."""
    n = anchor_q.shape[0]
    x = dict(feat=m["anchor_feat"], scaling=torch.exp(m["scaling_log"]),
             offsets=m["offsets"].reshape(n, -1))
    if noise is not None:
        hyper = m["hyper_latent"] + (noise["hyper"] - 0.5)
    else:
        hyper = straight_through(m["hyper_latent"],
                                 torch.round(m["hyper_latent"]))
    lik = prior_likelihood(m, hyper)
    coded = {s: torch.zeros_like(v) for s, v in x.items()}
    mean = {s: torch.zeros_like(v) for s, v in x.items()}
    scale = {s: torch.zeros_like(v) for s, v in x.items()}
    q = {s: torch.ones((n, 1), device=anchor_q.device) for s in STREAMS}
    for i in reversed(range(model.level_num)):
        rows = ((levels.level == i) & m["alive"])[:, None]
        e = predict(m, model, i, level_input(model, i, anchor_q, coded,
                                             levels, hyper))
        for s in STREAMS:
            if noise is not None:
                new = x[s] + (noise[(s, i)] - 0.5) * e.q[s]
            else:
                new = rounded_to_step(x[s], e.q[s]).detach()
            coded[s] = torch.where(rows, new, coded[s])
            mean[s] = torch.where(rows, e.mean[s], mean[s])
            scale[s] = torch.where(rows, e.scale[s], scale[s])
            q[s] = torch.where(rows, e.q[s], q[s])
    return Context(coded, Entropy(mean, scale, q), hyper, lik)


def rate(m: dict, model: Model, ctx: Context, u: torch.Tensor,
         sample_frac: float) -> torch.Tensor:
    """Bits a parameter, estimated on the kept anchors whose draw u is at
    most `sample_frac`, times the share of kept anchors among the alive."""
    n = u.shape[0]
    kept = kept_anchors(m)
    chosen = ((u <= sample_frac) & kept)[:, None].to(torch.float32)
    n_chosen = torch.clamp(chosen.sum(), min=1)
    alive = m["alive"].to(torch.float32)[:, None]
    kept_share = kept.sum() / torch.clamp(alive.sum(), min=1)
    x = dict(feat=m["anchor_feat"], scaling=torch.exp(m["scaling_log"]),
             offsets=m["offsets"].reshape(n, -1))
    on3 = torch.repeat_interleave(offset_mask(m), 3, dim=1)
    e = ctx.entropy
    bits = 0.0
    for s in STREAMS:
        x_mean = (x[s] * alive).sum() / torch.clamp(alive.sum()
                                                     * x[s].shape[1], min=1)
        b = gaussian_bits(ctx.coded[s], e.mean[s], e.scale[s], e.q[s],
                          x_mean) * chosen
        if s == "offsets":
            b = b * on3
        bits = bits + b.sum()
    bits = bits + (-torch.log2(ctx.hyper_likelihood) * chosen).sum()
    per = n_chosen * sum(stream_widths(model).values())
    return bits / per * kept_share


# -- neural gaussians ----------------------------------------------------

class Gaussians(NamedTuple):
    xyz: torch.Tensor          # [NK,3]
    color: torch.Tensor        # [NK,3]
    opacity: torch.Tensor      # [NK] zero where not valid
    scaling: torch.Tensor      # [NK,3]
    rot: torch.Tensor          # [NK,4]
    valid: torch.Tensor        # [NK] bool: opacity > 0, offset on, visible


def neural_gaussians(m: dict, model: Model, camera_center, visible, feat,
                     scaling, offsets, anchor, mask) -> Gaussians:
    """Each anchor's K gaussians from its feature and view: opacity
    tanh(MLP)·mask, colour sigmoid(MLP), scale (anchor scaling[3:]
    ·sigmoid) and rotation (normalized) from the covariance MLP, position
    anchor + offset·scaling[:3]. Rows are [feat, direction, distance] of
    the anchor seen from the camera."""
    n, k = anchor.shape[0], model.n_offsets
    view = anchor - camera_center[None]
    dist = torch.linalg.vector_norm(view, dim=1, keepdim=True)
    view = view / torch.clamp(dist, min=1e-12)
    rows = torch.cat([feat, view, dist], dim=1)
    opacity = torch.tanh(mlp(m, "opacity", rows)).reshape(n * k)
    opacity = opacity * mask.reshape(n * k)
    color = torch.sigmoid(mlp(m, "color", rows)).reshape(n * k, 3)
    cov = mlp(m, "cov", rows).reshape(n * k, 7)
    sc = torch.repeat_interleave(scaling, k, dim=0)
    rot = cov[:, 3:7]
    rot = rot / torch.clamp(torch.linalg.vector_norm(rot, dim=1,
                                                     keepdim=True), min=1e-12)
    xyz = (torch.repeat_interleave(anchor, k, dim=0)
           + offsets.reshape(n * k, 3) * sc[:, :3])
    valid = (opacity > 0) & torch.repeat_interleave(visible, k)
    return Gaussians(xyz=xyz, color=color,
                     opacity=torch.where(valid, opacity, 0.0),
                     scaling=sc[:, 3:] * torch.sigmoid(cov[:, :3]), rot=rot,
                     valid=valid)


def anchor_bounds(anchor: torch.Tensor, alive: torch.Tensor) -> tuple:
    """The anchors' quantization bounds: the alive anchors' least and
    largest coordinates, widened by a fifth."""
    big = torch.tensor(1e30, dtype=anchor.dtype, device=anchor.device)
    lo = torch.where(alive[:, None], anchor, big).amin(0, keepdim=True)
    hi = torch.where(alive[:, None], anchor, -big).amax(0, keepdim=True)
    return (torch.where(lo < 0, lo * 1.2, lo * 0.8),
            torch.where(hi > 0, hi * 1.2, hi * 0.8))
