"""`k1_roofline.serve`'s reader (`k1_roofline.serve.py` beside this file),
read in the fly-in cell's traced window: K1's frozen bound over its device
time, summed over the lap's views."""

from pathlib import Path

from perfbench.harness import load_module

_serve = load_module(Path(__file__).with_name("k1_roofline.serve.py"),
                     "perfbench_metric_k1_roofline_serve")
KEEP, read = _serve.KEEP, _serve.read
