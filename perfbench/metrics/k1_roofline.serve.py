"""K1's share of its roofline, in %: the least time the traced views' or
steps' inputs need (`perfbench/roofline.py`) over K1's device time in the
profiler's trace, summed over every call."""

from perfbench import roofline

KEEP = {"k1": ("contextgs_tpu_torch.ops.rasterize", "blend_forward")}


def read(r):
    return roofline.kernel_share(r, roofline.K1_KERNEL, roofline.k1_bound_ms)
