"""Training cells: `train.loop.train` resumed at `start_iteration` from a
checkpoint the harness writes of its seeded scene state, on seeded target
images over an orbit of views.

The resume puts every step of the window in the phase the mix names
(`start_iteration` past `context_from` for the context phase, past
`update_until` for no densification) with the published schedule. The
first `warmup_steps` steps are set-up; the window then runs until
`--seconds` have passed and ends from the loop's `callback`, so the program
runs unchanged. The first `checked_steps` steps are compared with the plain
reference (`reference/train.py`): each step's loss, each leaf's first
gradient as Adam receives it (its first moment after one step), and each
leaf's change after those steps.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from perfbench import compare, inputs, program
from perfbench.harness import Window, plant
from perfbench.reference.train import ADAM_B1, follow

STEP = "contextgs_tpu_torch.train.step"
CONTEXT = "contextgs_tpu_torch.models.context"
RASTER = "contextgs_tpu_torch.ops.rasterize"


class _Stop(Exception):
    """Raised from the training callback to end the window."""


def _halved(fn):
    """The loss over the upper half of the image rows only."""
    def call(a, b, *args, **kw):
        h = a.shape[-2] // 2
        return fn(a[..., :h, :], b[..., :h, :], *args, **kw)
    return call


# faults the tests plant in the program, each under (module, attribute)
FAULTS = {
    "unchanged_state": [(STEP, "adam_update",
                         lambda fn: lambda params, grads, adam, *a, **k:
                         (params, adam))],
    "half_batch": [(STEP, "l1_loss", _halved), (STEP, "ssim", _halved)],
}


def _iterations(traffic: dict) -> int:
    """Steps enough for any window."""
    return traffic["start_iteration"] + 10**7


class Job:
    # spans that name what the host does in the idle gaps
    NAME_SPANS = {
        "levels": (STEP, "build_level_maps"), "render": (STEP, "render"),
        "l1_loss": (STEP, "l1_loss"), "ssim": (STEP, "ssim"),
        "adam": (STEP, "adam_update"), "backward": ("torch.autograd", "grad"),
        "context": (CONTEXT, "multi_scale_generate"),
        "rate": (CONTEXT, "estimate_rate"),
        "visible_filter": (RASTER, "visible_filter"),
        "projection": (RASTER, "project_gaussians"),
        "binning": (RASTER, "expand_and_sort"),
        "K1": (RASTER, "blend_forward"), "K2": (RASTER, "blend_backward"),
    }

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.width, self.height = config["width"], config["height"]
        self.mcfg = inputs.model_config(config)
        self.faults: list = []
        self.captured: dict = {}
        # keep the first gradient and the change of every leaf whole, for
        # the look behind a reading (`control.py`)
        self.keep_full = False

    def _inputs(self):
        if not hasattr(self, "state"):
            cfg, dev = self.config, self.device
            self.state = inputs.anchor_state(cfg, self.seed, dev)
            self.nets = inputs.net_weights(cfg)
            self.scales = inputs.level_scales(self.state, cfg)
            self.images = inputs.targets(self.traffic, self.width,
                                         self.height, self.seed, dev)
            self.rng_state = np.random.default_rng(
                inputs.stream_seed(self.seed, "order")).bit_generator.state

    def _checkpoint(self, path: str) -> None:
        """The harness's state as the program's training checkpoint."""
        from contextgs_tpu_torch.train.optim import init_adam
        from contextgs_tpu_torch.utils.checkpoint import save_checkpoint

        params, buffers = program.params(self.state, self.nets, self.config,
                                         self.device)
        save_checkpoint(path, params, buffers, init_adam(params), dict(
            iteration=self.traffic["start_iteration"],
            voxel_size=self.mcfg.voxel_size, level_scales=self.scales,
            spatial_lr_scale=self.traffic["spatial_lr_scale"],
            rng_state=self.rng_state, cam_order=[]))

    def run(self, seconds: float, tracer=None) -> Window:
        from contextgs_tpu_torch.config import OptimizationConfig, TrainConfig
        from contextgs_tpu_torch.scene.cameras import Camera
        from contextgs_tpu_torch.scene.dataset_readers import SceneInfo
        from contextgs_tpu_torch.train import loop
        from contextgs_tpu_torch.models.state import param_leaves

        self._inputs()
        tr, dev = self.traffic, self.device
        start_it = tr["start_iteration"]
        warm, checked = tr["warmup_steps"], tr["checked_steps"]
        if warm < checked:
            raise ValueError("warmup_steps must cover checked_steps")
        start_leaves = dict(
            {f: self.state[f] for f in self.state},
            **{n: x.to(dev) for n, x in self.nets.items()})
        cams = [Camera(uid=i, colmap_id=i, R=r, T=t, fov_x=fx, fov_y=fy,
                       image=self.images[i], width=self.width,
                       height=self.height)
                for i, (r, t, fx, fy) in enumerate(inputs.orbit_poses(
                    tr, self.width, self.height))]
        # the loop initializes a model from the points before the resume
        # replaces it: a few points keep that step short
        pts = self.state["anchor"][:tr["init_points"]].double().cpu().numpy()
        scene = SceneInfo(points=pts, colors=np.zeros_like(pts),
                          normals=np.zeros_like(pts), train_cameras=cams,
                          test_cameras=[], radius=tr["spatial_lr_scale"])
        win = {"units": 0}
        cap = self.captured
        cap.update(loss=[], grad={}, change={})

        def callback(it, ts, metrics):
            k = it - start_it
            if k <= checked:
                cap["loss"].append(metrics.loss)
                if self.keep_full:
                    # each step's gradient from the first moments
                    mu = {n: m.detach().to("cpu", copy=True)
                          for n, m in ts.adam.mu.items()
                          if n.startswith(("mlps.", "prior."))}
                    prev = cap.get("_mu", {n: 0.0 for n in mu})
                    cap.setdefault("grads_steps", []).append(
                        {n: (mu[n] - ADAM_B1 * prev[n]) / (1 - ADAM_B1)
                         for n in mu})
                    cap["_mu"] = mu
                if k == 1:
                    cap["grad"] = {n: torch.linalg.vector_norm(
                        m.double()) / (1 - ADAM_B1)
                        for n, m in ts.adam.mu.items()}
                    if self.keep_full:
                        cap["grad_full"] = {n: m.cpu() / (1 - ADAM_B1)
                                            for n, m in ts.adam.mu.items()}
                if k == checked:
                    change = {n: x.detach() - start_leaves[n] for n, x in
                              param_leaves(ts.model.params).items()}
                    cap["change"] = {n: torch.linalg.vector_norm(d.double())
                                     for n, d in change.items()}
                    if self.keep_full:
                        cap["change_full"] = {n: d.cpu()
                                              for n, d in change.items()}
            if k == warm:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                win["start"] = time.perf_counter()
                if tracer is not None:
                    tracer.start()
                return
            if k < warm:
                return
            win["units"] += 1
            if tracer is not None:
                tracer.unit()
                if win["units"] >= tr["trace_units"]:
                    tracer.stop()
                    win["end"] = tracer.t1
                    raise _Stop
            elif time.perf_counter() - win["start"] >= seconds:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                win["end"] = time.perf_counter()
                raise _Stop

        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as \
                stack:
            path = os.path.join(tmp, "resume.pt")
            self._checkpoint(path)
            plant(stack, FAULTS, self.faults)
            cfg = TrainConfig(
                model=program.model_config(self.config),
                opt=OptimizationConfig(iterations=_iterations(tr)),
                seed=self.seed, start_checkpoint=path, test_iterations=(),
                save_iterations=())
            try:
                loop.train(cfg, scene, device=dev, callback=callback)
            except _Stop:
                pass
        cap["loss"] = [float(x) for x in cap["loss"]]
        cap["grad"] = {n: float(v) for n, v in cap["grad"].items()}
        cap["change"] = {n: float(v) for n, v in cap["change"].items()}
        return Window(start=win["start"], end=win["end"],
                      units=win["units"], attempted=win["units"])

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, tf32: bool) -> dict:
        cams = inputs.reference_cameras(self.traffic, self.width,
                                        self.height, self.device)
        return follow(self.state, self.nets, self.mcfg, cams, self.images,
                      self.scales, self.traffic["spatial_lr_scale"],
                      self.rng_state, self.seed,
                      self.traffic["start_iteration"],
                      self.traffic["checked_steps"], self.device, tf32,
                      keep=self.keep_full)

    def readings(self, got: dict, ref: dict) -> dict:
        """Every candidate number: the worst step's relative loss gap, the
        worst leaf's first-gradient gap, and the worst and the median
        moved leaf's change gap; the mix's `limits` say which are
        compared. The worst leaves and, where the whole tensors were kept,
        the look inside the worst-changed leaf go to `details`."""
        moved = compare.moved_leaves(ref["grad"])
        change = compare.leaf_gaps(got["change"], ref["change"], moved)
        worst = compare.worst_leaves(got["change"], ref["change"], moved)
        self.details = {
            "worst_grad": compare.worst_leaves(got["grad"], ref["grad"]),
            "worst_change": worst,
            "left_out": sorted(set(ref["grad"]) - set(moved))}
        if "change_full" in got and "change_full" in ref and worst:
            name = worst[0][0]
            self.details["inside_worst"] = compare.inside_leaf(
                got["grad_full"][name], ref["grad_full"][name],
                got["change_full"][name], ref["change_full"][name])
            if name in got.get("grads_steps", [{}])[0] and \
                    name in ref.get("grads_steps", [{}])[0]:
                self.details["inside_worst"]["steps"] = compare.step_gaps(
                    [g[name] for g in got["grads_steps"]],
                    [g[name] for g in ref["grads_steps"]])
        return {"loss_gap": compare.relative_gap(got["loss"], ref["loss"]),
                "grad_gap": compare.leaf_gap(got["grad"], ref["grad"]),
                "change_gap": max(change.values(), default=0.0),
                "change_gap_median": statistics.median(change.values())}

    def checks(self, control: bool = False) -> dict:
        """{number: (value, limit)}: the program's first steps (with
        `control`, the reference's in TF32) against the reference's."""
        self._inputs()
        ref = self._reference(False)
        got = self._reference(True) if control else self.captured
        limits = self.traffic["limits"]
        self.every = self.readings(got, ref)
        return {k: (v, limits[k]) for k, v in self.every.items()
                if k in limits}
