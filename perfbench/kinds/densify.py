"""Training cells of the anchor-growing phase: `train.loop.train` resumed at
`start_iteration` from a checkpoint the harness writes, whose state is a
pool of `capacity_headroom` times the configuration's anchors (rounded up
to 128 slots, as the program sizes its pool) with the extra slots free and
the statistics and Adam's moments zero. The published schedule then runs
plain-phase steps with a densification round every `update_interval`
steps; the configuration records that schedule, and a run refuses to
start where the program's defaults differ from it.

The scene is one of surfaces (`scenes`): the anchors lie on the faces of a
cube, and the targets are the reference's renders of those faces, while
the resumed state's anchors sit a small shift off them, as a scene fitted
part of the way does. Its gradients are coherent, so each round grows
anchors at every depth, as a real scene's rounds do (uniform random
targets grow next to none: their errors cancel over a gaussian).

Set-up resumes once and runs `warmup_steps` steps (1501–1600, the round at
1600 among them). Its first `checked_steps` steps and its round are what
the checks compare with the plain reference (`reference/densify.py`): the
steps as the context cell compares them, the four statistics after them,
and the round alone on the program's own state: its inputs and keep
draws captured at the round, the reference's round run on copies, and
the anchors alive in one result and not in the other counted.

The window is made of segments. Each resumes from the same checkpoint and
runs `segment_steps` steps (1501–1800: three rounds), so every segment
does the same work whatever speed the program reaches. The clock runs
from each segment's first step to its last, not through the resume
between segments; a new segment starts while fewer than `--seconds` of
clock have passed. A traced run traces `trace_units` steps of one segment
from `trace_from` + 1 (1597–1604, the round at 1600).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import inputs, program
from perfbench.harness import Window, plant, replaced
from perfbench.kinds import train
from perfbench.reference import densify as reference
from perfbench.reference import model as md

DENSIFY = "contextgs_tpu_torch.models.densify"
# the schedule's keys in a configuration file and in `OptimizationConfig`
SCHEDULE = ("start_stat", "update_from", "update_interval", "update_until",
            "densify_grad_threshold", "min_opacity", "success_threshold")


def _shallow(fn):
    """Growth at one depth fewer than the configuration's, the keep draws
    still drawn for every depth."""
    def call(params, buffers, adam, cfg, opt, voxel_size, generator=None,
             group=None, draws=None):
        if draws is None:
            draws = importlib.import_module(DENSIFY).keep_draws(
                generator, cfg.update_depth,
                params.offsets.shape[0] * cfg.n_offsets, params.anchor.device)
        return fn(params, buffers, adam, dataclasses.replace(
            cfg, update_depth=cfg.update_depth - 1), opt, voxel_size,
            generator, group, draws)
    return call


# faults the tests plant in the program, each under (module, attribute)
FAULTS = {
    **train.FAULTS,
    "no_stats": [(DENSIFY, "accumulate_stats",
                  lambda fn: lambda buffers, *a, **k: buffers)],
    "shallow_growth": [(DENSIFY, "adjust_anchors", _shallow)],
}


@dataclasses.dataclass
class Segments(Window):
    """The window of a segmented run: `clock` seconds of stepping, the
    resumes between segments left out."""

    clock: float = 0.0

    @property
    def seconds(self) -> float:
        return self.clock


def capacity(config: dict) -> int:
    """The pool's slots as the program sizes it: anchors times the
    headroom, rounded up to 128."""
    n = int(config["anchors"] * config["capacity_headroom"])
    return ((max(n, config["anchors"]) + 127) // 128) * 128


def pooled(state: dict, slots: int) -> dict:
    """`state` (every row alive) padded to `slots` slots, the extra ones
    free and zero."""
    n = state["alive"].shape[0]
    out = {}
    for name, x in state.items():
        if name.startswith("bound_"):
            out[name] = x
        else:
            out[name] = torch.cat([x, x.new_zeros((slots - n,)
                                                  + x.shape[1:])])
    return out


def pool_state(params, buffers, adam) -> dict:
    """Copies of the program's pool: the anchor fields, the statistics,
    `alive`, the bounds, and Adam's moments of the anchor fields under
    "mu" and "nu"."""
    out = {f: getattr(params, f).clone() for f in md.ANCHOR_FIELDS}
    out.update({f: getattr(buffers, f).clone() for f in reference.STATS
                + ("alive", "bound_min", "bound_max")})
    for w in ("mu", "nu"):
        out[w] = {f: getattr(adam, w)[f].clone() for f in md.ANCHOR_FIELDS}
    return out


def round_tables(before: dict, draws: torch.Tensor, after: dict,
                 config: dict) -> tuple:
    """One round of the program and of the reference: the reference's
    round (`reference.adjust_anchors`) run on the alive rows of `before`
    (a `pool_state` of the round's inputs) with the program's keep `draws`
    ([depth, slots·K]), and `after` (the program's result) → (the
    program's alive anchors, the reference's anchors), each a table of
    the bits of every field, Adam moment and statistic (`_table`)."""
    alive = before["alive"]
    model = inputs.model_config(config)
    m = {f: before[f][alive] for f in md.ANCHOR_FIELDS + reference.STATS}
    m.update(alive=alive[alive], bound_min=before["bound_min"],
             bound_max=before["bound_max"])
    moments = {w: {f: x[alive] for f, x in before[w].items()}
               for w in ("mu", "nu")}
    ref = reference.adjust_anchors(
        m, moments, model, reference.Schedule.of(config),
        config["voxel_size"],
        draws[:, alive.repeat_interleave(model.n_offsets)])

    def table(rows, moments):
        return _table([rows[f] for f in md.ANCHOR_FIELDS]
                      + [moments[w][f] for w in ("mu", "nu")
                         for f in md.ANCHOR_FIELDS]
                      + [rows[s] for s in reference.STATS])

    live = after["alive"]
    prog = {f: after[f][live] for f in md.ANCHOR_FIELDS + reference.STATS}
    prog_moments = {w: {f: x[live] for f, x in after[w].items()}
                    for w in ("mu", "nu")}
    return table(prog, prog_moments), table(ref["m"], ref["moments"])


def round_off(before: dict, draws: torch.Tensor, after: dict,
              config: dict) -> int:
    """The anchors alive in the program's result of a round and not in the
    reference's, or the reverse, matched by the bits of every field
    (`round_tables`)."""
    return rows_off(*round_tables(before, draws, after, config))


def _table(fields: list) -> torch.Tensor:
    """[rows, columns] int32: the bits of each row's fields side by
    side."""
    return torch.cat([f.reshape(f.shape[0], -1).contiguous()
                      .view(torch.int32) for f in fields], dim=1)


def rows_off(a: torch.Tensor, b: torch.Tensor) -> int:
    """The rows of `a` not in `b` plus those of `b` not in `a`, as
    multisets of bit patterns."""
    _, inv = torch.unique(torch.cat([a, b]), dim=0, return_inverse=True)
    groups = int(inv.max()) + 1 if inv.numel() else 0
    ca = torch.bincount(inv[:a.shape[0]], minlength=groups)
    cb = torch.bincount(inv[a.shape[0]:], minlength=groups)
    return int((ca - cb).abs().sum())


def scenes(config: dict, seed: int, device) -> tuple:
    """(the scene the views show, the state training resumes from): each
    `inputs.anchor_state`'s draws with the anchors moved onto the faces of
    the cube of half-size `extent` about the origin (a face drawn, then a
    point on it, uniformly) and the bounds taken anew; the resumed state's
    anchors are the shown ones moved by `anchor_shift`, as the anchors of a
    scene fitted part of the way lie off the surfaces its views show."""
    shown = inputs.anchor_state(config, seed, device)
    g = torch.Generator(device).manual_seed(inputs.stream_seed(seed,
                                                               "targets"))
    n = config["anchors"]
    on = torch.rand((n, 3), generator=g, device=device) * 2 - 1
    face = torch.randint(0, 3, (n,), generator=g, device=device)
    side = torch.where(torch.rand(n, generator=g, device=device) < 0.5,
                       -1.0, 1.0)
    on[torch.arange(n, device=device), face] = side
    on = on * config["extent"]
    off = on + torch.tensor(config["anchor_shift"], dtype=torch.float32,
                            device=device)
    resumed = dict(shown)
    for state, anchor in ((shown, on), (resumed, off)):
        state["anchor"] = anchor
        state["bound_min"], state["bound_max"] = md.anchor_bounds(
            anchor, state["alive"])
    return shown, resumed


def target_renders(shown: dict, nets: dict, config: dict, traffic: dict,
                   width: int, height: int, device) -> np.ndarray:
    """[views, H, W, 3] float32: the shown scene (`scenes`) rendered by the
    reference from each view of the orbit on a black background, handed
    over on the host, where the training loop takes its images from."""
    model = inputs.model_config(config)
    m = reference.alive_rows(shown)
    m.update({k: v.to(device) for k, v in nets.items()})
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    screen = torch.zeros((m["anchor"].shape[0] * model.n_offsets, 2),
                         dtype=torch.float32, device=device)
    out = []
    with torch.no_grad():
        for cam in inputs.reference_cameras(traffic, width, height, device):
            image = reference.render(m, model, cam, width, height, bg,
                                     screen)[0]
            out.append(image.permute(1, 2, 0).cpu())
    return torch.stack(out).numpy()


@dataclasses.dataclass
class Traced(Window):
    """The window of a traced run, with the program's records
    (`trace.Records`) as the metrics' readers took them."""

    records: list = dataclasses.field(default_factory=list)


class Job(train.Job):
    NAME_SPANS = dict(train.Job.NAME_SPANS,
                      densify=(DENSIFY, "adjust_anchors"),
                      stats=(DENSIFY, "accumulate_stats"))

    def _inputs(self):
        if not hasattr(self, "state"):
            cfg, dev = self.config, self.device
            shown, resumed = scenes(cfg, self.seed, dev)
            self.state = pooled(resumed, capacity(cfg))
            self.nets = inputs.net_weights(cfg)
            self.scales = None
            self.images = target_renders(shown, self.nets, cfg, self.traffic,
                                         self.width, self.height, dev)
            self.rng_state = np.random.default_rng(
                inputs.stream_seed(self.seed, "order")).bit_generator.state

    def _scene(self):
        from contextgs_tpu_torch.scene.cameras import Camera
        from contextgs_tpu_torch.scene.dataset_readers import SceneInfo

        tr = self.traffic
        cams = [Camera(uid=i, colmap_id=i, R=r, T=t, fov_x=fx, fov_y=fy,
                       image=self.images[i], width=self.width,
                       height=self.height)
                for i, (r, t, fx, fy) in enumerate(inputs.orbit_poses(
                    tr, self.width, self.height))]
        # the loop initializes a model from the points before the resume
        # replaces it: a few points keep that step short
        pts = self.state["anchor"][:tr["init_points"]].double().cpu().numpy()
        return SceneInfo(points=pts, colors=np.zeros_like(pts),
                         normals=np.zeros_like(pts), train_cameras=cams,
                         test_cameras=[], radius=tr["spatial_lr_scale"])

    def _config(self, path: str, last: int):
        from contextgs_tpu_torch.config import OptimizationConfig, TrainConfig

        opt = OptimizationConfig(iterations=last)
        differ = [k for k in SCHEDULE if getattr(opt, k) != self.config[k]]
        if differ:
            raise ValueError(f"the program's schedule differs from the "
                             f"configuration's in {differ}")
        return TrainConfig(model=program.model_config(self.config), opt=opt,
                           seed=self.seed,
                           start_checkpoint=path, test_iterations=(),
                           save_iterations=())

    def _capture(self, fn):
        """Keep each round's counts of grown and pruned anchors (on the
        device, read after the run), and the first round's state before
        and after it and its keep draws."""
        job = self
        mod = importlib.import_module(DENSIFY)

        def call(params, buffers, adam, *args, **kw):
            if "round" in job.captured:
                res = fn(params, buffers, adam, *args, **kw)
                job.counts.append((res.n_grown, res.n_pruned))
                return res
            before = pool_state(params, buffers, adam)
            kept = []

            def keep(draw):
                def drawn(*a, **k):
                    kept.append(draw(*a, **k))
                    return kept[-1]
                return drawn

            with replaced(mod, "keep_draws", keep):
                res = fn(params, buffers, adam, *args, **kw)
            job.counts.append((res.n_grown, res.n_pruned))
            job.captured["round"] = dict(
                before=before, draws=kept[0],
                after=pool_state(res.params, res.buffers, res.adam))
            return res
        return call

    def _clocked(self, make):
        """The loop's step maker, its steps marking each segment's first
        step on the clock."""
        job = self

        def maker(*args, **kw):
            step = make(*args, **kw)

            def call(*a, **k):
                if job._first is None:
                    if job.device.type == "cuda":
                        torch.cuda.synchronize()
                    job._first = time.perf_counter()
                return step(*a, **k)
            return call
        return maker

    def _segment(self, path: str, scene, last: int, callback) -> tuple:
        """Resume at the checkpoint and step to `last` (or until `callback`
        stops it) → (first step's start, last step's end) on the clock."""
        from contextgs_tpu_torch.train import loop

        self._first, self._last = None, None
        try:
            loop.train(self._config(path, last), scene, device=self.device,
                       callback=callback)
        except train._Stop:
            pass
        return self._first, self._last

    def _sync_time(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    def run(self, seconds: float, tracer=None) -> Window:
        from contextgs_tpu_torch.models.state import param_leaves
        from contextgs_tpu_torch.train import loop

        self._inputs()
        tr, dev = self.traffic, self.device
        start_it = tr["start_iteration"]
        warm, checked = tr["warmup_steps"], tr["checked_steps"]
        seg_last = start_it + tr["segment_steps"]
        start_leaves = dict(
            {f: self.state[f] for f in md.ANCHOR_FIELDS},
            **{n: x.to(dev) for n, x in self.nets.items()})
        alive0 = self.state["alive"]
        cap = self.captured
        cap.update(loss=[], grad={}, change={}, stats={})
        self.counts = []
        scene = self._scene()

        def warm_callback(it, ts, metrics):
            k = it - start_it
            if k <= checked:
                cap["loss"].append(metrics.loss)
            if k == 1:
                cap["grad"] = {n: torch.linalg.vector_norm(m.double())
                               / (1 - train.ADAM_B1)
                               for n, m in ts.adam.mu.items()}
            if k == checked:
                cap["change"] = {n: torch.linalg.vector_norm(
                    (x.detach() - start_leaves[n]).double())
                    for n, x in param_leaves(ts.model.params).items()}
                cap["stats"] = {s: getattr(ts.model.buffers, s)[alive0]
                                .clone() for s in reference.STATS}

        def window_callback(it, ts, metrics):
            if tracer is not None:
                if it == tr["trace_from"]:
                    self._sync_time()
                    tracer.start()
                elif it > tr["trace_from"]:
                    tracer.unit()
                    if it == tr["trace_from"] + tr["trace_units"]:
                        tracer.stop()
                        raise train._Stop
            elif it == seg_last:
                self._last = self._sync_time()

        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as \
                stack:
            path = os.path.join(tmp, "resume.pt")
            self._checkpoint(path)
            plant(stack, FAULTS, self.faults)
            stack.enter_context(replaced(importlib.import_module(DENSIFY),
                                         "adjust_anchors", self._capture))
            stack.enter_context(replaced(loop, "make_train_step",
                                         self._clocked))

            self._segment(path, scene, start_it + warm, warm_callback)
            setup_rounds = len(self.counts)
            clock, units, first, each = 0.0, 0, None, []
            while tracer is None and clock < seconds:
                a, b = self._segment(path, scene, seg_last, window_callback)
                first = a if first is None else first
                each.append(round(b - a, 4))
                clock += b - a
                units += tr["segment_steps"]
            if tracer is not None:
                self._segment(path, scene, seg_last, window_callback)
        cap["loss"] = [float(x) for x in cap["loss"]]
        cap["grad"] = {n: float(v) for n, v in cap["grad"].items()}
        cap["change"] = {n: float(v) for n, v in cap["change"].items()}
        counts = [tuple(int(x) for x in c) for c in self.counts]
        segment = counts[setup_rounds:setup_rounds + tr["segment_steps"]
                         // self.config["update_interval"]]
        self.rounds = dict(setup=counts[:setup_rounds], segment=segment,
                           alive=int(alive0.sum()) + sum(g - p for g, p in
                                                         segment))
        print(f"rounds (grown, pruned): set-up {self.rounds['setup']}; a "
              f"segment {segment}, {self.rounds['alive']} anchors alive at "
              f"its end; segments {each} s", file=sys.stderr)
        if tracer is not None:
            return self._traced(Traced(start=tracer.t0, end=tracer.t1,
                                       units=tr["trace_units"],
                                       attempted=tr["trace_units"]))
        return Segments(start=first, end=first + clock, units=units,
                        attempted=units, clock=clock)

    def _traced(self, window: "Traced") -> "Traced":
        """`window`, keeping the program's records as the first of the
        metrics' readers takes them (`trace.take` drains them), until the
        job is released."""
        from contextgs_tpu_torch.utils import trace

        def keep(take):
            def taken():
                window.records.append(take())
                return window.records[-1]
            return taken
        self._keeping = contextlib.ExitStack()
        self._keeping.enter_context(replaced(trace, "take", keep))
        return window

    def release(self) -> None:
        super().release()
        if hasattr(self, "_keeping"):
            self._keeping.close()

    def _reference(self, tf32: bool) -> dict:
        cams = inputs.reference_cameras(self.traffic, self.width,
                                        self.height, self.device)
        return reference.follow_plain(
            self.state, self.nets, self.mcfg, cams, self.images,
            self.traffic["spatial_lr_scale"], self.rng_state,
            self.traffic["start_iteration"], self.traffic["checked_steps"],
            self.device, tf32)

    def densify_off(self) -> int:
        """The first round alone, on the program's own state
        (`round_off`)."""
        rnd = self.captured["round"]
        return round_off(rnd["before"], rnd["draws"], rnd["after"],
                         self.config)

    def readings(self, got: dict, ref: dict) -> dict:
        out = super().readings(got, ref)
        out["stats_gap"] = max(
            float(torch.linalg.vector_norm((got["stats"][s]
                                            - ref["stats"][s]).double())
                  / max(float(torch.linalg.vector_norm(
                      ref["stats"][s].double())), 1e-30))
            for s in reference.STATS)
        return out

    def checks(self, control: bool = False) -> dict:
        """{number: (value, limit)}: the program's first steps and first
        round (with `control`, the reference's steps in TF32) against the
        reference's."""
        self._inputs()
        ref = self._reference(False)
        got = self._reference(True) if control else self.captured
        limits = self.traffic["limits"]
        self.every = self.readings(got, ref)
        if not control:
            self.every["densify_off"] = self.densify_off()
        return {k: (v, limits[k]) for k, v in self.every.items()
                if k in limits}
