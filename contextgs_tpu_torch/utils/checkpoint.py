"""Training checkpoints (port of `contextgs_tpu/utils/checkpoint.py`).

One `torch.save` file holds the training state: every parameter (the MLPs'
by their module path), the buffers, the Adam moments and count, and a meta
dict. With the meta the training loop stores (iteration, camera RNG state,
pending camera order, torch generator state), a resumed run repeats the
continuous one. Tensors are saved on the CPU and loaded onto `device`.
"""

from __future__ import annotations

import torch

from contextgs_tpu_torch.models.state import (ANCHOR_FIELDS, Buffers, Params,
                                              param_leaves, prior_from_leaves)
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
