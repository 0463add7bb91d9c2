"""Checkpoints (port of `contextgs_tpu/utils/checkpoint.py`).

Training: one `torch.save` file holds the training state: every parameter
(the MLPs' by their module path), the buffers, the Adam moments and count,
and a meta dict. With the meta the training loop stores (iteration, camera
RNG state, pending camera order, torch generator state), a resumed run
repeats the continuous one. Tensors are saved on the CPU and loaded onto
`device`. `load_checkpoint` also reads the JAX package's training
checkpoint, without JAX: `chkpnt{it}.pkl`, a pickle of `{"leaves",
"treedef"}` for dict(params, buffers, adam) in `jax.tree.flatten` order
(keys sorted, NamedTuple fields in order, `None` leaves absent), with its
meta pickled beside it as `chkpnt{it}.meta.pkl`. It tells the two formats
apart by content: `torch.save` writes a zip archive.

The codec's `mlp.pkl`: `save_pytree` and `load_pytree` write and read the
JAX package's format without JAX, a pickle of `{"leaves": [numpy arrays],
"treedef": str}` whose leaves are those of `jax.tree.flatten(dict(mlps=...,
prior=...))` in its order (`state.net_leaves`), each Linear weight as the
reference's [in, out].
"""

from __future__ import annotations

import pickle
import zipfile

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
    """→ (params, buffers, adam, meta), from a checkpoint of either package.
    `params` gives the structure: its MLP modules receive the saved weights
    in place, its anchor fields and prior are replaced by the saved tensors
    (the pool may have grown). A JAX checkpoint's meta has no
    `generator_state`."""
    if zipfile.is_zipfile(path):
        data = torch.load(path, map_location="cpu", weights_only=True)
        saved, meta = data["params"], data["meta"]
        buffers = data["buffers"]
        adam = (data["adam_mu"], data["adam_nu"], int(data["adam_count"]))
    else:
        saved, buffers, adam = _read_jax_checkpoint(path, params)
        with open(path[:-len(".pkl")] + ".meta.pkl", "rb") as f:
            meta = pickle.load(f)

    def put(x):
        return x.to(device)

    with torch.no_grad():
        for name, p in params.mlps.named_parameters():
            p.copy_(saved[f"mlps.{name}"])
    params = params._replace(prior=prior_from_leaves(
        {name: put(x) for name, x in saved.items()
         if name.startswith("prior.")}),
                             **{f: put(saved[f]) for f in ANCHOR_FIELDS})
    buffers = Buffers(**{f: put(x) for f, x in buffers.items()})
    mu, nu, count = adam
    adam = AdamState(mu={n: put(x) for n, x in mu.items()},
                     nu={n: put(x) for n, x in nu.items()}, count=count)
    return params, buffers, adam, meta


def _read_jax_checkpoint(path: str, like: Params) -> tuple:
    """The JAX package's `save_pytree(dict(params, buffers, adam))` as CPU
    tensors keyed like the port's: (params, buffers, (mu, nu, count)), each
    Linear weight transposed to [out, in]. Raises where the saved treedef
    is not that of `like`'s structure or a leaf's shape differs (the
    anchor fields' capacity may)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    want = _checkpoint_treedef(like.mlps, like.prior)
    if data["treedef"] != want:
        raise ValueError(f"{path}: treedef differs from this ModelConfig's "
                         f"training state:\n{data['treedef']}\nexpected\n"
                         f"{want}")
    leaves = iter(data["leaves"])
    shapes = {name: tuple(x.shape) for name, x in param_leaves(like).items()}

    def tensor(name, a, shape=None):
        a = np.asarray(a)
        if name.endswith(".weight"):
            a = a.T
        if shape is not None and (
                a.shape[1:] != shape[1:] if name in ANCHOR_FIELDS
                else a.shape != shape):
            raise ValueError(f"{path}: leaf {name} has shape {a.shape}, "
                             f"expected {shape}")
        return torch.from_numpy(np.array(a))

    def tree():
        return {n: tensor(n, next(leaves), s) for n, s in shapes.items()}

    mu, nu = tree(), tree()
    count = int(next(leaves))
    buffers = {f: tensor(f, next(leaves)) for f in Buffers._fields}
    params = tree()
    return params, buffers, (mu, nu, count)


def _net_nodes(mlps: DecoderMLPs, prior: FactorizedPrior) -> tuple:
    """The reference's `str(treedef)` nodes of DecoderMLPs and
    FactorizedPrior."""
    linear = "CustomNode(namedtuple[Linear], [*, *])"
    mlp = f"CustomNode(namedtuple[MLP], [{linear}, {linear}])"
    n = len(mlps.grid)
    grid = f"({', '.join([mlp] * n)}{',' if n == 1 else ''})"
    bank = "None" if mlps.feature_bank is None else mlp
    nets = (f"CustomNode(namedtuple[DecoderMLPs], "
            f"[{mlp}, {mlp}, {mlp}, {grid}, {bank}])")
    parts = ", ".join(f"({', '.join('*' * len(x))})" for x in prior)
    return nets, f"CustomNode(namedtuple[FactorizedPrior], [{parts}])"


def _treedef(mlps: DecoderMLPs, prior: FactorizedPrior) -> str:
    """`str(treedef)` of the reference's dict(mlps=..., prior=...)."""
    nets, prior_node = _net_nodes(mlps, prior)
    return f"PyTreeDef({{'mlps': {nets}, 'prior': {prior_node}}})"


def _checkpoint_treedef(mlps: DecoderMLPs, prior: FactorizedPrior) -> str:
    """`str(treedef)` of the reference's training checkpoint,
    dict(params=..., buffers=..., adam=...)."""
    stars = ", ".join("*" * len(ANCHOR_FIELDS))
    params = (f"CustomNode(namedtuple[Params], [{stars}, "
              f"{', '.join(_net_nodes(mlps, prior))}])")
    adam = f"CustomNode(namedtuple[AdamState], [{params}, {params}, *])"
    buffers = (f"CustomNode(namedtuple[Buffers], "
               f"[{', '.join('*' * len(Buffers._fields))}])")
    return (f"PyTreeDef({{'adam': {adam}, 'buffers': {buffers}, "
            f"'params': {params}}})")


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
