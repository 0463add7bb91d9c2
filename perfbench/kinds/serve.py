"""Serving cells: one closed-loop viewer walking an orbit of views round
and round through `evaluation.make_decoded_renderer`'s `render`, over a
decoded scene the harness draws from the seed.

Each view is timed on the host clock from the call until
`torch.cuda.synchronize()` returns; the next view is sent then. Set-up
draws the scene, builds the renderer and renders one lap of the orbit. The
window runs until `--seconds` have passed. The latest image of each of
`checked_views` views, drawn from the seed, is compared after the window
with the plain reference's render of that view (`reference/serve.py`).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import compare, inputs, program
from perfbench.harness import Window, plant
from perfbench.reference.serve import make_renderer
from perfbench.reference.train import precision

RASTER = "contextgs_tpu_torch.ops.rasterize"
EVAL = "contextgs_tpu_torch.evaluation"


def _altered(fn):
    """A 16x16 block of every image 0.05 brighter where it is produced."""
    def call(*args, **kw):
        out = fn(*args, **kw)
        image = out.image.clone()
        image[:, :16, :16] += 0.05
        return out._replace(image=image)
    return call


FAULTS = {"altered_answer": [(RASTER, "rasterize", _altered)]}


def decoded_arrays(state: dict, k: int) -> dict:
    """The decoded scene's arrays from the harness's anchor state: linear
    scaling and hard masks, as `decode_scene` hands them over."""
    return dict(anchor=state["anchor"], feat=state["anchor_feat"],
                scaling=torch.exp(state["scaling_log"]),
                offsets=state["offsets"].reshape(-1, k, 3),
                masks=(state["mask_logit"] > 0).to(torch.float32),
                hyper=state["hyper_latent"])


class Job:
    NAME_SPANS = {
        "visible_filter": (RASTER, "visible_filter"),
        "decode": (EVAL, "decode_neural_gaussians"),
        "projection": (RASTER, "project_gaussians"),
        "binning": (RASTER, "expand_and_sort"),
        "K1": (RASTER, "blend_forward"),
    }

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.width, self.height = config["width"], config["height"]
        self.mcfg = inputs.model_config(config)
        self.faults: list = []
        self.images: dict = {}
        rng = np.random.default_rng(inputs.stream_seed(self.seed, "order"))
        self.checked = sorted(int(v) for v in rng.choice(
            traffic["views"], traffic["checked_views"], replace=False))

    def _inputs(self):
        if not hasattr(self, "scene"):
            state = inputs.anchor_state(self.config, self.seed, self.device)
            self.scene = decoded_arrays(state, self.mcfg.n_offsets)
            self.nets = inputs.net_weights(self.config)

    def run(self, seconds: float, tracer=None) -> Window:
        from contextgs_tpu_torch.compression.codec import DecodedScene
        from contextgs_tpu_torch.config import TrainConfig
        from contextgs_tpu_torch.evaluation import make_decoded_renderer
        from contextgs_tpu_torch.scene.cameras import Camera

        self._inputs()
        dev, tr = self.device, self.traffic
        mcfg = program.model_config(self.config)
        s = self.scene
        dec = DecodedScene(anchor=s["anchor"], feat=s["feat"],
                           scaling=s["scaling"], offsets=s["offsets"],
                           masks=s["masks"], hyper=s["hyper"],
                           mlps=program.mlps(self.nets, self.config, dev),
                           prior=None, level_scales=[],
                           voxel_size=mcfg.voxel_size)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (
            lambda: None)
        with contextlib.ExitStack() as stack:
            plant(stack, FAULTS, self.faults)
            render = make_decoded_renderer(dec, TrainConfig(model=mcfg),
                                           self.width, self.height, dev)
            cams = [Camera(uid=i, colmap_id=i, R=r, T=t, fov_x=fx, fov_y=fy,
                           image=None, width=self.width,
                           height=self.height).as_device_dict()
                    for i, (r, t, fx, fy) in enumerate(inputs.orbit_poses(
                        tr, self.width, self.height))]
            bg = torch.zeros(3, dtype=torch.float32, device=dev)
            order = inputs.view_order(tr["views"], self.seed)
            for v in order:
                render(cams[v], bg)
            sync()
            lat, units = [], 0
            if tracer is not None:
                tracer.start()
            start = time.perf_counter()
            while True:
                v = order[units % len(order)]
                t0 = time.perf_counter()
                img = render(cams[v], bg)
                sync()
                t1 = time.perf_counter()
                lat.append(t1 - t0)
                units += 1
                if v in self.checked:
                    self.images[v] = img
                if tracer is not None:
                    tracer.unit()
                    if units >= tr["trace_units"]:
                        tracer.stop()
                        break
                elif t1 - start >= seconds:
                    break
        return Window(start=start, end=t1, units=units, latencies=lat,
                      attempted=units)

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, views, tf32: bool) -> dict:
        render = make_renderer(self.scene, self.nets, self.mcfg, self.width,
                               self.height, self.device)
        cams = inputs.reference_cameras(self.traffic, self.width,
                                        self.height, self.device)
        bg = torch.zeros(3, dtype=torch.float32, device=self.device)
        with precision(tf32):
            return {v: render(cams[v], bg) for v in views}

    def checks(self, control: bool = False) -> dict:
        """{number: (value, limit)}: the checked views the window rendered
        last (with `control`, the reference's in TF32) against the
        reference's."""
        self._inputs()
        views = self.checked if control else sorted(self.images)
        ref = self._reference(views, False)
        got = self._reference(views, True) if control else self.images
        worst_max, worst_mean = compare.image_gaps(
            [got[v] for v in views], [ref[v] for v in views])
        limits = self.traffic["limits"]
        # every checked view is due in a window that walks a whole lap
        missing = float(len(self.checked) - len(views))
        return {"image_max_abs": (worst_max, limits["image_max_abs"]),
                "image_mean_abs": (worst_mean, limits["image_mean_abs"]),
                "views_missing": (missing, 0.0)}
