"""`mfu.serve`'s reader (`mfu.serve.py` beside this file), read in the
fly-in cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_serve = load_module(Path(__file__).with_name("mfu.serve.py"),
                     "perfbench_metric_mfu_serve")
KEEP, SHAPES, read = _serve.KEEP, _serve.SHAPES, _serve.read
