"""ms a view in the program's `render/cull`, `raster/project` and
`raster/bin` spans (anchor cull, projection, two-sort binning), on the host
clock of the traced run (`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    return spans.per_unit(r, "host_ms", ["render/cull", "raster/project",
                                         "raster/bin"])
