"""ms a view in the neural-gaussian decode of the visible anchors
(`models/decode.decode_neural_gaussians`), by CUDA events around the call
from `evaluation`."""

SPANS = {"decode": ("contextgs_tpu_torch.evaluation",
                    "decode_neural_gaussians")}


def read(r):
    return r.span_ms("decode") / r.units if r.units else None
