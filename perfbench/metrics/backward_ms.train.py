"""ms a training step in the backward (`torch.autograd.grad` in
`train/step`: K2, the MLPs' and the context model's gradients), by CUDA
events around the call."""

SPANS = {"backward": ("torch.autograd", "grad")}


def read(r):
    return r.span_ms("backward") / r.units if r.units else None
