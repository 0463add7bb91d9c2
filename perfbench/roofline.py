"""The yardstick of the tile-blend kernels K1 and K2: the H100's published
peaks, the operations and bytes that a frame's inputs need, and the pairs
of pixels and instances counted by the reference's plain blend
(`reference/raster.blend`), so that a change to the program cannot move
it.

A kernel's least time is the largest of its bytes at the HBM rate, its
float32 operations at the CUDA cores' rate and its exps at the
special-function units' rate. Bytes are counted once: the rows of the
gaussians that have tile instances, the ids and bounds read, the outputs
written. Operations are counted for the pairs that the result needs (those
that reach alpha >= 1/255), not for the pairs a kernel walks.
"""

from __future__ import annotations

import torch

from perfbench.reference import raster

PEAK_FP32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
# exp on the special-function units: 16 results per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock; the run prints the
# card's SM clock beside it
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# float32 operations the result needs of a (pixel, instance) pair that
# reaches alpha >= 1/255: K1 its power (11), exp and clamp (2), T·(1-α) (2)
# and the blend (7); K2 its power and exp (13) and the 48 of the gradient
NEED_K1 = dict(tested=11 + 2 + 2, blended=7)
NEED_K2 = dict(bwd_blended=11 + 2 + 48)
TILE = 16
K1_KERNEL = "blend_forward_kernel"
K2_KERNEL = "blend_backward_kernel"


def bound_ms(n_bytes: float, n_ops: float, n_exp: float) -> float:
    return max(n_bytes / PEAK_HBM_BYTES, n_ops / PEAK_FP32_FLOPS,
               n_exp / SFU_EXP_PER_S) * 1e3


def needed_ops(pairs: dict, need: dict) -> int:
    return sum(n * pairs[k] for k, n in need.items())


def k1_bound_ms(rows, ids, bounds, width, height, pairs) -> float:
    rows_read = int(torch.unique(ids).numel())
    n_bytes = (rows_read * rows.shape[1] * 4 + ids.numel() * 4
               + bounds.numel() * 4 + height * width * (3 + 1 + 1) * 4)
    return bound_ms(n_bytes, needed_ops(pairs, NEED_K1), pairs["tested"])


def k2_bound_ms(rows, ids, bounds, width, height, pairs) -> float:
    rows_read = int(torch.unique(ids).numel())
    n_bytes = (rows_read * rows.shape[1] * 4 + ids.numel() * 4
               + bounds.numel() * 4
               + height * width * (3 + 1 + 1 + 3 + 1) * 4 + rows.numel() * 4)
    return bound_ms(n_bytes, needed_ops(pairs, NEED_K2),
                    pairs["bwd_blended"])


def k1_calls(reading) -> list:
    """[(rows, ids, bounds, width, height, pairs)] of every K1 call the
    traced window kept (`KEEP = {"k1": ...}`), the pairs counted once."""
    def compute():
        out = []
        for args, kw in reading.kept("k1"):
            rows, ids, bounds, width, height = args[:5]
            pairs: dict = {}
            with torch.no_grad():
                r = rows.detach()
                raster.blend(r[:, 0:2], r[:, 2:5], r[:, 5], r[:, 6:9], ids,
                             bounds, width, height, counts=pairs)
            # K2 walks each pixel's list back from its last blended pair
            pairs["bwd_blended"] = pairs["blended"]
            out.append((rows, ids, bounds, width, height, pairs))
        return out
    return reading.cached("k1_calls", compute)


def kernel_share(reading, kernel: str, bound) -> float | None:
    """The kernel's bound over its device time, in %, summed over the kept
    calls; None where the trace has not one kernel per kept call."""
    calls = k1_calls(reading)
    times = reading.kernels(kernel)
    if not calls or len(times) != len(calls):
        return None
    need = sum(bound(*c) for c in calls)
    took = sum(e - s for _, s, e in times) / 1e3
    return 100.0 * need / took if took > 0 else None


def linear_flops(reading) -> int:
    """2·rows·in·out of every `torch.nn.functional.linear` call kept
    (`SHAPES = {"linear": ...}`): x [.., in], weight [out, in]."""
    total = 0
    for shapes in reading.shapes("linear"):
        x, w = shapes[0], shapes[1]
        rows = 1
        for d in x[:-1]:
            rows *= d
        total += 2 * rows * w[0] * w[1]
    return total
