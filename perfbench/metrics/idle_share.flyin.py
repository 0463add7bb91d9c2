"""`idle_share.serve`'s reader (`idle_share.serve.py` beside this file), read
in the fly-in cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_serve = load_module(Path(__file__).with_name("idle_share.serve.py"),
                     "perfbench_metric_idle_share_serve")
read = _serve.read
