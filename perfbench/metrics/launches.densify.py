"""`launches.train`'s reader (`launches.train.py` beside this file), read in the
densify cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_train = load_module(Path(__file__).with_name("launches.train.py"),
                     "perfbench_metric_launches_train")
read = _train.read
