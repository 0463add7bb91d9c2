"""ms a training step in the context model's forward: the level maps
(`models/levels.build_level_maps`), the level-wise quantization
(`models/context.multi_scale_generate`) and the rate estimate
(`estimate_rate`, `entropy`), by CUDA events around each call."""

SPANS = {"context": [
    ("contextgs_tpu_torch.train.step", "build_level_maps"),
    ("contextgs_tpu_torch.models.context", "multi_scale_generate"),
    ("contextgs_tpu_torch.models.context", "estimate_rate")]}


def read(r):
    return r.span_ms("context") / r.units if r.units else None
