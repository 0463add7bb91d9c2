"""Model snapshots: the attribute-named anchor PLY and the network
checkpoint (port of `contextgs_tpu/scene/snapshot.py`).

The same PLY attribute names and the same transposed offset layout (offsets
stored as [3,K] flattened), alive anchors only, so that a snapshot of either
package reads in the other. `checkpoint.pth` is `utils/checkpoint.save_pytree`
of the MLPs and the prior (the codec's `mlp.pkl` format), with the metadata
pickled beside it as `checkpoint.pth.meta`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from contextgs_tpu_torch.config import ModelConfig
from contextgs_tpu_torch.models.state import Buffers, Params, SceneModel
from contextgs_tpu_torch.scene.ply_io import read_ply, write_ply
from contextgs_tpu_torch.utils.checkpoint import load_pytree, save_pytree


def save_model_ply(path: str, params: Params, buffers: Buffers) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    alive = buffers.alive

    def rows(x):
        return x[alive].detach().cpu().numpy()

    anchor = rows(params.anchor)
    n, k = anchor.shape[0], params.offsets.shape[1]
    fields: dict[str, np.ndarray] = {}
    for i, c in enumerate("xyz"):
        fields[c] = anchor[:, i].astype(np.float32)
    for c in ("nx", "ny", "nz"):
        fields[c] = np.zeros(n, np.float32)
    offsets = rows(params.offsets).transpose(0, 2, 1).reshape(n, -1)
    for i in range(offsets.shape[1]):
        fields[f"f_offset_{i}"] = offsets[:, i].astype(np.float32)
    masks = rows(params.mask_logit).reshape(n, k)
    for i in range(k):
        fields[f"f_mask_{i}"] = masks[:, i].astype(np.float32)
    for prefix, x in (("f_anchor_feat", params.anchor_feat),
                      ("f_hyper_latent", params.hyper_latent)):
        x = rows(x)
        for i in range(x.shape[1]):
            fields[f"{prefix}_{i}"] = x[:, i].astype(np.float32)
    fields["opacity"] = rows(params.opacity_raw)[:, 0].astype(np.float32)
    for prefix, x in (("scale", params.scaling_log), ("rot", params.rotation)):
        x = rows(x)
        for i in range(x.shape[1]):
            fields[f"{prefix}_{i}"] = x[:, i].astype(np.float32)
    write_ply(path, fields)


def load_model_ply(path: str, cfg: ModelConfig,
                   template: SceneModel) -> SceneModel:
    """Load a snapshot into a padded model of at least the template's
    capacity on the template's device; the MLP and prior leaves are the
    template's (load them with `load_networks`)."""
    v = read_ply(path)
    n = len(v["x"])
    k = cfg.n_offsets
    cap = max(template.buffers.alive.shape[0], ((n + 127) // 128) * 128)
    dev = template.params.anchor.device

    def grab(prefix, m):
        return np.stack([v[f"{prefix}_{i}"] for i in range(m)], axis=1)

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    params = template.params._replace(
        anchor=pad(np.stack([v["x"], v["y"], v["z"]], axis=1)),
        anchor_feat=pad(grab("f_anchor_feat", cfg.feat_dim)),
        hyper_latent=pad(grab("f_hyper_latent", cfg.hyper_dim)),
        offsets=pad(grab("f_offset", 3 * k).reshape(n, 3, k)
                    .transpose(0, 2, 1)),
        mask_logit=pad(grab("f_mask", k)),
        scaling_log=pad(grab("scale", 6)),
        rotation=pad(grab("rot", 4)),
        opacity_raw=pad(v["opacity"][:, None]))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    buffers = template.buffers._replace(
        alive=torch.arange(cap, device=dev) < n,
        opacity_accum=zeros(cap), anchor_denom=zeros(cap),
        offset_grad_accum=zeros(cap, k), offset_denom=zeros(cap, k))
    return SceneModel(params, buffers)


def save_networks(path: str, params: Params, extra: dict | None = None) -> None:
    """MLPs + factorized prior + metadata (ref save_mlp_checkpoints :912-936)."""
    save_pytree(path, params.mlps, params.prior)
    if extra is not None:
        with open(path + ".meta", "wb") as f:
            pickle.dump(extra, f)


def load_networks(path: str, cfg: ModelConfig, device):
    """→ (mlps, prior, extra) on `device`; extra is None without a .meta."""
    mlps, prior = load_pytree(path, cfg, device)
    extra = None
    if os.path.exists(path + ".meta"):
        with open(path + ".meta", "rb") as f:
            extra = pickle.load(f)
    return mlps, prior, extra
