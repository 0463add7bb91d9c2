"""`carry_card_share.train`'s reader (`carry_card_share.train.py` beside this
file), read in the densify cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_train = load_module(Path(__file__).with_name("carry_card_share.train.py"),
                     "perfbench_metric_carry_card_share_train")
read = _train.read
