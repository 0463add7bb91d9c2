"""Checkpoints (port of `contextgs_tpu/utils/checkpoint.py`).

Training: one `torch.save` file holds the training state: every parameter
(the MLPs' by their module path), the buffers, the Adam moments and count,
and a meta dict. With the meta the training loop stores (iteration, camera
RNG state, pending camera order, torch generator state), a resumed run
repeats the continuous one. Tensors are saved on the CPU and loaded onto
`device`.

The codec's `mlp.pkl`: `save_pytree` and `load_pytree` write and read the
JAX package's format without JAX, a pickle of `{"leaves": [numpy arrays],
"treedef": str}` whose leaves are those of `jax.tree.flatten(dict(mlps=...,
prior=...))` in its order (`state.net_leaves`), each Linear weight as the
reference's [in, out].
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from contextgs_tpu_torch.config import ModelConfig
from contextgs_tpu_torch.models.entropy import (FactorizedPrior,
                                                init_factorized_prior)
from contextgs_tpu_torch.models.mlps import DecoderMLPs
from contextgs_tpu_torch.models.state import (ANCHOR_FIELDS, Buffers, Params,
                                              net_leaves, param_leaves,
                                              prior_from_leaves)
from contextgs_tpu_torch.train.optim import AdamState


def _cpu(tensors: dict) -> dict:
    return {name: x.detach().cpu() for name, x in tensors.items()}


def save_checkpoint(path: str, params: Params, buffers: Buffers,
                    adam: AdamState, meta: dict) -> None:
    torch.save(dict(params=_cpu(param_leaves(params)),
                    buffers=_cpu(buffers._asdict()),
                    adam_mu=_cpu(adam.mu), adam_nu=_cpu(adam.nu),
                    adam_count=adam.count, meta=meta), path)


def load_checkpoint(path: str, params: Params, device) -> tuple:
    """→ (params, buffers, adam, meta). `params` gives the structure: its
    MLP modules receive the saved weights in place, its anchor fields and
    prior are replaced by the saved tensors (the pool may have grown)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    saved = data["params"]

    def put(x):
        return x.to(device)

    with torch.no_grad():
        for name, p in params.mlps.named_parameters():
            p.copy_(saved[f"mlps.{name}"])
    params = params._replace(prior=prior_from_leaves(
        {name: put(x) for name, x in saved.items()
         if name.startswith("prior.")}),
                             **{f: put(saved[f]) for f in ANCHOR_FIELDS})
    buffers = Buffers(**{f: put(x) for f, x in data["buffers"].items()})
    adam = AdamState(mu={n: put(x) for n, x in data["adam_mu"].items()},
                     nu={n: put(x) for n, x in data["adam_nu"].items()},
                     count=int(data["adam_count"]))
    return params, buffers, adam, data["meta"]


def _treedef(mlps: DecoderMLPs, prior: FactorizedPrior) -> str:
    """`str(treedef)` of the reference's dict(mlps=..., prior=...)."""
    linear = "CustomNode(namedtuple[Linear], [*, *])"
    mlp = f"CustomNode(namedtuple[MLP], [{linear}, {linear}])"
    n = len(mlps.grid)
    grid = f"({', '.join([mlp] * n)}{',' if n == 1 else ''})"
    bank = "None" if mlps.feature_bank is None else mlp
    nets = (f"CustomNode(namedtuple[DecoderMLPs], "
            f"[{mlp}, {mlp}, {mlp}, {grid}, {bank}])")
    parts = ", ".join(f"({', '.join('*' * len(x))})" for x in prior)
    return (f"PyTreeDef({{'mlps': {nets}, 'prior': "
            f"CustomNode(namedtuple[FactorizedPrior], [{parts}])}})")


def save_pytree(path: str, mlps: DecoderMLPs,
                prior: FactorizedPrior) -> None:
    """Write the MLPs and the prior as the reference's `save_pytree` writes
    dict(mlps=..., prior=...)."""
    leaves = [(x.t() if name.endswith(".weight") else x).detach().cpu()
              .contiguous().numpy()
              for name, x in net_leaves(mlps, prior).items()]
    with open(path, "wb") as f:
        pickle.dump({"leaves": leaves, "treedef": _treedef(mlps, prior)}, f)


@torch.no_grad()
def load_pytree(path: str, cfg: ModelConfig,
                device) -> tuple[DecoderMLPs, FactorizedPrior]:
    """(mlps, prior) on `device` from a file of either package's
    `save_pytree`, with the structure of `cfg`."""
    with open(path, "rb") as f:
        saved = pickle.load(f)["leaves"]
    mlps = DecoderMLPs(cfg, torch.Generator())
    prior = init_factorized_prior(cfg.hyper_dim, torch.Generator())
    like = net_leaves(mlps, prior)
    if len(saved) != len(like):
        raise ValueError(f"{path} has {len(saved)} leaves, expected "
                         f"{len(like)} for this ModelConfig")
    for (name, x), a in zip(like.items(), saved):
        a = np.asarray(a, np.float32)
        if name.endswith(".weight"):
            a = a.T
        if a.shape != tuple(x.shape):
            raise ValueError(f"{path}: leaf {name} has shape {a.shape}, "
                             f"expected {tuple(x.shape)}")
        x.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return mlps.to(device), FactorizedPrior(
        *(tuple(x.to(device) for x in field) for field in prior))
