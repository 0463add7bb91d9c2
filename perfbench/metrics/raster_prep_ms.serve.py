"""ms a view in the rasterizer's preparation: the anchor cull
(`visible_filter`), the projection (`project_gaussians`) and the two-sort
binning (`expand_and_sort`), by CUDA events around each call."""

RASTER = "contextgs_tpu_torch.ops.rasterize"
SPANS = {"raster_prep": [(RASTER, "visible_filter"),
                         (RASTER, "project_gaussians"),
                         (RASTER, "expand_and_sort")]}


def read(r):
    return r.span_ms("raster_prep") / r.units if r.units else None
