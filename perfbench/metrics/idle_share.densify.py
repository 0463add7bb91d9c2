"""`idle_share.train`'s reader (`idle_share.train.py` beside this file), read in the
densify cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_train = load_module(Path(__file__).with_name("idle_share.train.py"),
                     "perfbench_metric_idle_share_train")
read = _train.read
