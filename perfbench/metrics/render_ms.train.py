"""ms a training step in `models/renderer.render` (the forward: cull,
context quantization, decode, projection, binning, K1), by CUDA events
around each call from `train/step`."""

SPANS = {"render": ("contextgs_tpu_torch.train.step", "render")}


def read(r):
    return r.span_ms("render") / r.units if r.units else None
