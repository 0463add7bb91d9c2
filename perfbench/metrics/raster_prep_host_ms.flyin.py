"""`raster_prep_host_ms.serve`'s reader (`raster_prep_host_ms.serve.py` beside this file), read
in the fly-in cell's traced window."""

from pathlib import Path

from perfbench.harness import load_module

_serve = load_module(Path(__file__).with_name("raster_prep_host_ms.serve.py"),
                     "perfbench_metric_raster_prep_host_ms_serve")
read = _serve.read
