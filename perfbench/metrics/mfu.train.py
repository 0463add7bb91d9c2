"""The whole training step's share of the card's float32 peak, in %: the
operations counted from shapes (the decoder and context MLPs' products,
three times over for the forward and the backward, and the operations K1's
and K2's inputs need) over the traced window's seconds at 67 TFLOP/s."""

from perfbench import roofline

KEEP = {"k1": ("contextgs_tpu_torch.ops.rasterize", "blend_forward")}
SHAPES = {"linear": ("torch.nn.functional", "linear")}


def read(r):
    if not r.units:
        return None
    ops = 3 * roofline.linear_flops(r)
    for *_, pairs in roofline.k1_calls(r):
        ops += (roofline.needed_ops(pairs, roofline.NEED_K1)
                + roofline.needed_ops(pairs, roofline.NEED_K2))
    return 100.0 * ops / (r.window_s * roofline.PEAK_FP32_FLOPS)
