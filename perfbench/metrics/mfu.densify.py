"""`mfu.train`'s reader (`mfu.train.py` beside this file), read in the
densify cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_train = load_module(Path(__file__).with_name("mfu.train.py"),
                     "perfbench_metric_mfu_train")
KEEP, SHAPES, read = _train.KEEP, _train.SHAPES, _train.read
