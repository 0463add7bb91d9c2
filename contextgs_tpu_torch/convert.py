"""Carry the reference's weights and state across to the port.

The JAX package's `Params`, `Buffers` and `DecodedScene` come in as nested
numpy arrays (for example `jax.tree.map(np.asarray, params)`), read by field
name, and go out as the port's objects on `device`. The reference's
`Linear.w` is [in, out]; `nn.Linear.weight` is [out, in], so it is
transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from contextgs_tpu_torch.compression.codec import DecodedScene
from contextgs_tpu_torch.config import ModelConfig
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.models.mlps import MLP, DecoderMLPs
from contextgs_tpu_torch.models.state import Buffers, Params


def _tensor(x, device) -> torch.Tensor:
    a = np.array(x)                     # a writable, contiguous copy
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def _load_mlp(mlp: MLP, src) -> None:
    with torch.no_grad():
        for lin, s in ((mlp.l1, src.l1), (mlp.l2, src.l2)):
            w = np.asarray(s.w, np.float32)
            if tuple(lin.weight.shape) != w.shape[::-1]:
                raise ValueError(f"Linear weight {w.shape} does not fit "
                                 f"{tuple(lin.weight.shape)}")
            lin.weight.copy_(torch.from_numpy(np.array(w.T)))
            lin.bias.copy_(torch.from_numpy(np.array(s.b, np.float32)))


def mlps_from_numpy(mlps, cfg: ModelConfig, device=None) -> DecoderMLPs:
    """Reference `DecoderMLPs` (numpy leaves) → the port's module."""
    dev = resolve_device(device)
    out = DecoderMLPs(cfg)
    _load_mlp(out.opacity, mlps.opacity)
    _load_mlp(out.cov, mlps.cov)
    _load_mlp(out.color, mlps.color)
    if len(mlps.grid) != len(out.grid):
        raise ValueError(f"{len(mlps.grid)} grid MLPs for level_num "
                         f"{cfg.level_num}")
    for dst, src in zip(out.grid, mlps.grid):
        _load_mlp(dst, src)
    if (mlps.feature_bank is None) != (out.feature_bank is None):
        raise ValueError("feature bank presence differs from cfg.use_feat_bank")
    if out.feature_bank is not None:
        _load_mlp(out.feature_bank, mlps.feature_bank)
    return out.to(dev)


def _prior_from_numpy(prior, device) -> dict | None:
    if prior is None:
        return None
    return {name: [_tensor(x, device) for x in getattr(prior, name)]
            for name in prior._fields}


def params_from_numpy(params, cfg: ModelConfig, device=None) -> Params:
    dev = resolve_device(device)
    arrays = {name: _tensor(getattr(params, name), dev)
              for name in Params._fields if name not in ("mlps", "prior")}
    return Params(**arrays, mlps=mlps_from_numpy(params.mlps, cfg, dev),
                  prior=_prior_from_numpy(params.prior, dev))


def buffers_from_numpy(buffers, device=None) -> Buffers:
    dev = resolve_device(device)
    return Buffers(**{name: _tensor(getattr(buffers, name), dev)
                      for name in Buffers._fields})


def decoded_scene_from_numpy(dec, cfg: ModelConfig,
                             device=None) -> DecodedScene:
    dev = resolve_device(device)
    arrays = {name: _tensor(getattr(dec, name), dev)
              for name in ("anchor", "feat", "scaling", "offsets", "masks",
                           "hyper")}
    return DecodedScene(**arrays, mlps=mlps_from_numpy(dec.mlps, cfg, dev),
                        prior=_prior_from_numpy(dec.prior, dev),
                        level_scales=list(dec.level_scales),
                        voxel_size=float(dec.voxel_size))
