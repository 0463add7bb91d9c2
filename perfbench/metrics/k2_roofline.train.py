"""K2's share of its roofline, in %: the least time the traced steps'
inputs need (`perfbench/roofline.py`) over K2's device time in the
profiler's trace, summed over every call."""

from perfbench import roofline

KEEP = {"k1": ("contextgs_tpu_torch.ops.rasterize", "blend_forward")}


def read(r):
    return roofline.kernel_share(r, roofline.K2_KERNEL, roofline.k2_bound_ms)
