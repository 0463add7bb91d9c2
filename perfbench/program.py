"""The harness's inputs in the program's own types: its `ModelConfig`, its
decoder MLPs with the harness's weights, and its `Params` and `Buffers`
over the harness's tensors. Imported by the kinds inside a run only, so
that a checkout without the program fails there."""

from __future__ import annotations

import torch


def model_config(config: dict):
    """The program's `ModelConfig` with the fields of the configuration
    file that it has."""
    from contextgs_tpu_torch.config import ModelConfig

    return ModelConfig(**{f: config[f] for f in ModelConfig.__dataclass_fields__
                          if f in config})


def mlps(nets: dict, config: dict, device):
    """The program's `DecoderMLPs` holding the weights `nets`."""
    from contextgs_tpu_torch.models.mlps import DecoderMLPs

    out = DecoderMLPs(model_config(config))
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(nets[f"mlps.{name}"])
    return out.to(device)


def params(state: dict, nets: dict, config: dict, device) -> tuple:
    """(Params, Buffers) of the program over the harness's tensors."""
    from contextgs_tpu_torch.models.entropy import FactorizedPrior
    from contextgs_tpu_torch.models.state import (ANCHOR_FIELDS, Buffers,
                                                  Params)

    fields = {f: [] for f in FactorizedPrior._fields}
    for name, x in nets.items():
        if name.startswith("prior."):
            fields[name.split(".")[1]].append(x.to(device))
    p = Params(mlps=mlps(nets, config, device),
               prior=FactorizedPrior(**{k: tuple(v)
                                        for k, v in fields.items()}),
               **{f: state[f] for f in ANCHOR_FIELDS})
    return p, Buffers(**{f: state[f] for f in Buffers._fields})
