"""`bin_card_share.serve`'s reader (`bin_card_share.serve.py` beside this
file), read in the densify cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_serve = load_module(Path(__file__).with_name("bin_card_share.serve.py"),
                     "perfbench_metric_bin_card_share_serve")
read = _serve.read
