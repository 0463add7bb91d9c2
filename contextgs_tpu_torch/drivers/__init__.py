"""The port's command-line drivers, in the roles of the JAX package's root
`train.py`, `decompress.py`, `test.py` and `bench.py`:

    python -m contextgs_tpu_torch.drivers.train -s <scene> -m <out>
    python -m contextgs_tpu_torch.drivers.decompress -s <scene> -m <out>
    python -m contextgs_tpu_torch.drivers.test -s <scene> -m <out>
    python -m contextgs_tpu_torch.drivers.bench

Each runs on the CUDA card, or raises where there is none; `--force_cpu`
is the only way to run one on the CPU. Each `main(argv)` returns the exit
code. Flags of the JAX drivers that have no meaning in the port are
refused with a message that says why.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

import numpy as np
import torch

from contextgs_tpu_torch.config import NO_BUDGET, TrainConfig
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.scene.dataset_readers import SceneInfo, load_scene

LOGGER = "contextgs_tpu_torch"


class Refused(argparse.Action):
    """A flag of the JAX package that has no meaning in the port: giving it
    fails the parse with the reason, which is the flag's help after
    "refused: "."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is refused: "
                     f"{self.help.removeprefix('refused: ')}")


def add_common(p) -> None:
    """The flags every driver takes besides its own."""
    p.add_argument("--budget", action=Refused, help="refused: " + NO_BUDGET)
    p.add_argument("--force_cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions of the "
                        "kernels); without it the driver runs on the CUDA "
                        "card or raises")


def check_common(p, args) -> torch.device:
    """The device `--force_cpu` asks for."""
    return resolve_device("cpu" if args.force_cpu else None)


def read_config(model_path: str) -> TrainConfig:
    """The `cfg_args` a training run of either package wrote."""
    with open(os.path.join(model_path, "cfg_args")) as f:
        return TrainConfig.from_json(f.read())


def scene_of(cfg: TrainConfig, source_path: str) -> SceneInfo:
    return load_scene(source_path, images=cfg.images,
                      eval_split=cfg.model.eval, lod=cfg.model.lod,
                      white_background=cfg.model.white_background,
                      resolution=cfg.model.resolution)


def background(cfg: TrainConfig) -> np.ndarray:
    return np.asarray([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], np.float32)


@contextlib.contextmanager
def logging_to(model_path: str = ""):
    """INFO records of the port's logger to stderr and, with a model_path,
    to `<model_path>/outputs.log`, for the duration of the block."""
    log = logging.getLogger(LOGGER)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    handlers = [logging.StreamHandler(sys.stderr)]
    if model_path:
        os.makedirs(model_path, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(model_path, "outputs.log")))
    level = log.level
    log.setLevel(logging.INFO)
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    try:
        yield log
    finally:
        for h in handlers:
            log.removeHandler(h)
            h.close()
        log.setLevel(level)
