"""Training cells that grow anchors under quantization: `train.loop.train`
resumed at `start_iteration` in the noise phase (3001–10000) or the
context phase (10001–15000), whichever it falls in, with the published
schedule: a densification round every `update_interval` steps. The design
is `kinds/densify.py`'s: a checkpoint the harness writes of a pool of
`capacity_headroom` times the anchors with the statistics and Adam's
moments zero, each segment resumed alike, the clock counting stepping
only, and a round compared alone on the program's own inputs.

The scene is the configuration's: a city where it has `city` keys
(`kinds/flyin.city`, the voxel found in set-up), else `densify`'s cube.
The resumed anchors sit `anchor_shift` off the shown ones, so each round
grows at every depth. The targets are the shown scene's renders by the
program's decoded-scene renderer (`evaluation.make_decoded_renderer`):
data, not the compared output. The views are the fly-in's lap where the
mix has `far` (`kinds/flyin.flyin_poses`), else the orbit. A context
phase's checkpoint carries the level scales, searched once in set-up over
the kept anchors (`inputs.level_scales`). Its pending camera order puts
the checked views first: `fixed_views`, then views drawn from the seed,
then the rest in a seeded order; after it the loop draws its own.

What the checks compare with the plain reference (`reference/grow.py`):

- the first `checked_steps` steps, on the program's own draws (captured
  at the alive rows): each step's loss, each leaf's first gradient and
  its change, and the four statistics after them, as `densify` compares
  them;
- the checked round alone, on the program's own inputs (`densify_off`):
  the mix's `checked_round` at its first run, in set-up or in the first
  segment (the city's first round after the resume grows nothing at the
  last depth, since its statistics start from zero; its second does), else
  the set-up's last round; a traced run, which stops before a later
  round, checks the set-up's last;
- in the context phase, `levels_off`: the pool slots whose level or
  parent, as the first step after a round at the checked round's
  iteration builds them, differ from the reference's levels of that pool
  (`reference.pool_levels`).

Where the checked round lies in the first segment, its copies of the pool
and of the level maps are made inside that segment's clock: a few ms in a
segment of tens of seconds.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import sys

import numpy as np
import torch

from perfbench import inputs
from perfbench.harness import plant, replaced
from perfbench.kinds import densify, flyin
from perfbench.reference import grow as reference
from perfbench.reference import model as md
from perfbench.reference import raster

STEP = "contextgs_tpu_torch.train.step"
QUANT = "contextgs_tpu_torch.models.quant"
CONTEXT = "contextgs_tpu_torch.models.context"
# the phase boundaries in a configuration file and in `OptimizationConfig`
BOUNDS = ("noise_from", "context_from")


def _stale(fn):
    """The level maps of the pool before a round, at the step after it:
    a step whose pool (its `alive`) is not the last step's takes the last
    step's maps."""
    last = {}

    def call(params, buffers, *args, **kw):
        maps = fn(params, buffers, *args, **kw)
        stale = last.get("maps") if last.get("alive") is not None and \
            last["alive"] is not buffers.alive else None
        last.update(maps=maps, alive=buffers.alive)
        return maps if stale is None else stale
    return call


# faults the tests plant in the program, each under (module, attribute)
FAULTS = {**densify.FAULTS,
          "stale_levels": [(STEP, "kept_level_maps", _stale)]}


def city_state(city: dict, device) -> dict:
    """The city's anchor fields (`kinds/flyin.city`) with the fields of
    `inputs.anchor_state` it lacks: unit rotations, raw opacity
    log(0.1/0.9), every slot alive, the bounds from the anchors and the
    statistics zero."""
    n, k = city["offsets"].shape[:2]
    f32 = dict(dtype=torch.float32, device=device)
    state = dict(city,
                 rotation=torch.tensor([1.0, 0.0, 0.0, 0.0],
                                       device=device).repeat(n, 1),
                 opacity_raw=torch.full((n, 1), math.log(0.1 / 0.9), **f32),
                 alive=torch.ones(n, dtype=torch.bool, device=device),
                 opacity_accum=torch.zeros(n, **f32),
                 anchor_denom=torch.zeros(n, **f32),
                 offset_grad_accum=torch.zeros((n, k), **f32),
                 offset_denom=torch.zeros((n, k), **f32))
    state["bound_min"], state["bound_max"] = md.anchor_bounds(
        state["anchor"], state["alive"])
    return state


def scenes(config: dict, seed: int, device) -> tuple:
    """(the shown scene, the resumed state, the voxel size): the city of
    a configuration with `city` keys, its resumed anchors moved by
    `anchor_shift`; else `densify.scenes`'s cube."""
    if "city" not in config:
        return (*densify.scenes(config, seed, device), config["voxel_size"])
    city, voxel = flyin.city(config, seed, device)
    shown = city_state(city, device)
    shift = torch.tensor(config["anchor_shift"], dtype=torch.float32,
                         device=device)
    resumed = dict(shown, anchor=shown["anchor"] + shift)
    resumed["bound_min"], resumed["bound_max"] = md.anchor_bounds(
        resumed["anchor"], resumed["alive"])
    return shown, resumed, voxel


def poses(traffic: dict, width: int, height: int) -> list:
    """(R, T, fov_x, fov_y) of the mix's views: the fly-in's lap where it
    has `far`, else the orbit."""
    if "far" in traffic:
        return flyin.flyin_poses(traffic, width, height)
    return inputs.orbit_poses(traffic, width, height)


def target_renders(shown: dict, nets: dict, config: dict, views: list,
                   width: int, height: int, device) -> np.ndarray:
    """[views, H, W, 3] float32: the shown scene rendered from each view
    by the program's decoded-scene renderer on a black background, handed
    over on the host, where the training loop takes its images from."""
    from contextgs_tpu_torch.compression.codec import DecodedScene
    from contextgs_tpu_torch.config import TrainConfig
    from contextgs_tpu_torch.evaluation import make_decoded_renderer
    from contextgs_tpu_torch.scene.cameras import Camera

    from perfbench import program
    from perfbench.kinds import serve

    mcfg = program.model_config(config)
    s = serve.decoded_arrays(shown, mcfg.n_offsets)
    render = make_decoded_renderer(
        DecodedScene(anchor=s["anchor"], feat=s["feat"],
                     scaling=s["scaling"], offsets=s["offsets"],
                     masks=s["masks"], hyper=s["hyper"],
                     mlps=program.mlps(nets, config, device), prior=None,
                     level_scales=[], voxel_size=mcfg.voxel_size),
        TrainConfig(model=mcfg), width, height, device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    out = [render(Camera(uid=i, colmap_id=i, R=r, T=t, fov_x=fx, fov_y=fy,
                         image=None, width=width,
                         height=height).as_device_dict(), bg)
           .permute(1, 2, 0).cpu() for i, (r, t, fx, fy) in enumerate(views)]
    return torch.stack(out).numpy()


def first_views(traffic: dict, seed: int) -> tuple:
    """(the views of the checked steps, the pending camera order that
    puts them first, the state of the loop's camera stream after it):
    `fixed_views`, then views drawn from the seed, then the rest in a
    seeded order; the loop pops the order from its end."""
    rng = np.random.default_rng(inputs.stream_seed(seed, "order"))
    fixed = list(traffic["fixed_views"])
    rest = [v for v in range(traffic["views"]) if v not in fixed]
    drawn = [int(v) for v in rng.choice(
        rest, traffic["checked_steps"] - len(fixed), replace=False)]
    first = fixed + drawn
    others = [int(v) for v in rng.permutation(
        [v for v in rest if v not in drawn])]
    return first, (first + others)[::-1], rng.bit_generator.state


class Job(densify.Job):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.poses = poses(traffic, self.width, self.height)
        self.views, self.cam_order, self.rng_state = first_views(traffic,
                                                                 self.seed)

    def _inputs(self):
        if not hasattr(self, "state"):
            dev = self.device
            shown, resumed, voxel = scenes(self.config, self.seed, dev)
            self.config = dict(self.config, voxel_size=voxel)
            self.mcfg = inputs.model_config(self.config)
            self.state = densify.pooled(resumed, densify.capacity(
                self.config))
            self.nets = inputs.net_weights(self.config)
            self.phase = ("context" if self.traffic["start_iteration"]
                          >= self.config.get("context_from", 10_000)
                          else "noise")
            self.scales = (inputs.level_scales(self.state, self.config)
                           if self.phase == "context" else None)
            self.images = target_renders(shown, self.nets, self.config,
                                         self.poses, self.width,
                                         self.height, dev)

    def _checkpoint(self, path: str) -> None:
        """The harness's state as the program's training checkpoint, its
        pending camera order the checked views first."""
        from contextgs_tpu_torch.train.optim import init_adam
        from contextgs_tpu_torch.utils.checkpoint import save_checkpoint

        from perfbench import program

        params, buffers = program.params(self.state, self.nets, self.config,
                                         self.device)
        save_checkpoint(path, params, buffers, init_adam(params), dict(
            iteration=self.traffic["start_iteration"],
            voxel_size=self.mcfg.voxel_size, level_scales=self.scales,
            spatial_lr_scale=self.traffic["spatial_lr_scale"],
            rng_state=self.rng_state, cam_order=list(self.cam_order)))

    def _config(self, path: str, last: int):
        cfg = super()._config(path, last)
        differ = [k for k in BOUNDS if k in self.config
                  and getattr(cfg.opt, k) != self.config[k]]
        if differ:
            raise ValueError(f"the program's phases differ from the "
                             f"configuration's in {differ}")
        return cfg

    def _segment(self, path: str, scene, last: int, callback) -> tuple:
        self._levels_next = False
        return super()._segment(path, scene, last, callback)

    def _round_iterations(self, traced: bool) -> tuple:
        """(the iteration of each round the run makes, in order, as a
        function of the round's index; the iteration of the checked round;
        the set-up's rounds):
        the set-up's rounds, then each segment's alike. The checked round
        is the mix's `checked_round`, else the set-up's last; a traced run,
        whose segment stops at `trace_from` + `trace_units`, checks the
        set-up's last round where the checked one lies past the set-up."""
        tr, every = self.traffic, self.config["update_interval"]
        first = tr["start_iteration"] // every
        setup = (tr["start_iteration"] + tr["warmup_steps"]) // every - first
        seg = (tr["start_iteration"] + tr["segment_steps"]) // every - first
        setup_last = (first + setup) * every
        checked = tr.get("checked_round", setup_last)
        if traced and checked > setup_last:
            checked = setup_last

        def iteration(n: int) -> int:
            k = n if n < setup else (n - setup) % seg
            return (first + k + 1) * every
        return iteration, checked, setup

    # -- what the window keeps for the checks -----------------------------
    def _keep_draws(self, fn):
        """The draw function of the phase, keeping the alive rows of the
        first `checked_steps` steps' draws."""
        job = self
        alive = self.state["alive"]

        def call(*args, **kw):
            out = fn(*args, **kw)
            kept = job.captured["draws"]
            if job.phase == "context":
                if len(kept) < job.traffic["checked_steps"]:
                    kept.append(_context_rows(out, alive, job.mcfg))
            elif len(kept) < 3 * job.traffic["checked_steps"]:
                kept.append(out[alive].clone())
            return out
        return call

    def _keep_levels(self, fn):
        """The step's render, keeping the level maps and the pool of the
        first step after the checked round's iteration in a segment."""
        job = self

        def call(params, buffers, *args, **kw):
            if job._levels_next and "levels" not in job.captured and \
                    kw.get("maps") is not None:
                maps = kw["maps"]
                job.captured["levels"] = dict(
                    level=maps.level.clone(), parent=maps.parent.clone(),
                    pool={f: getattr(params, f).detach().clone()
                          for f in ("anchor", "mask_logit")},
                    alive=buffers.alive.clone(),
                    bound_min=buffers.bound_min.clone(),
                    bound_max=buffers.bound_max.clone())
            return fn(params, buffers, *args, **kw)
        return call

    def _capture(self, fn):
        """Keep each round's counts of grown and pruned anchors (on the
        device, read after the run); the checked round's state before and
        after it and its keep draws (`densify_off`), taken at its first
        run; and the pool's `alive` before and after each of the set-up's
        rounds and the checked one, with the new anchors' first scale
        (`_depths`)."""
        job = self
        mod = importlib.import_module(densify.DENSIFY)
        iteration, checked, setup = self._round_iterations(
            self._traced_run)

        def call(params, buffers, adam, *args, **kw):
            n = len(job.counts)
            it = iteration(n)
            first = it == checked and "round" not in job.captured
            keep = n < setup or first
            alive = buffers.alive.clone() if keep else None
            with contextlib.ExitStack() as stack:
                if first:
                    before = densify.pool_state(params, buffers, adam)
                    draws = []
                    stack.enter_context(replaced(mod, "keep_draws", _kept(
                        draws)))
                res = fn(params, buffers, adam, *args, **kw)
            job.counts.append((res.n_grown, res.n_pruned))
            job._levels_next = it == checked
            if first:
                job.captured["round"] = dict(
                    before=before, draws=draws[0], iteration=it,
                    grown=res.n_grown,
                    after=densify.pool_state(res.params, res.buffers,
                                             res.adam))
            if keep:
                job._grown.append((it, alive, res.buffers.alive,
                                   res.params.scaling_log[:, 0].clone()))
            return res
        return call

    def _depths(self) -> list:
        """[iteration, anchors grown at each depth] of each of the set-up's
        rounds and the checked one, the depths told apart by the voxel size
        their scalings start from."""
        cfg = self.config
        at = torch.tensor([cfg["voxel_size"] * (
            cfg["update_init_factor"] // cfg["update_hierachy_factor"] ** i)
            for i in range(cfg["update_depth"])], dtype=torch.float64)
        out = []
        for it, before, after, scale in self._grown:
            size = torch.exp(scale[after & ~before].double()).cpu()
            depth = (size[:, None] / at[None] - 1).abs().argmin(1)
            out.append([it, torch.bincount(depth, minlength=len(at))
                        .tolist()])
        return out

    def _clamped(self) -> int:
        """Anchors the checked round grew outside the quantization bounds,
        which the quantization clamps to the first or the last code."""
        after = self.captured["round"]["after"]
        new = after["alive"] & ~self.captured["round"]["before"]["alive"]
        anchor = after["anchor"][new]
        return int(((anchor < after["bound_min"])
                    | (anchor > after["bound_max"])).any(1).sum())

    def run(self, seconds: float, tracer=None):
        """`densify`'s run on the mix's views, keeping the checked steps'
        draws and the levels of the first step after a round; the faults
        of this kind's own are planted here, `densify`'s by it."""
        self._inputs()
        self.captured["draws"] = []
        self._traced_run = tracer is not None
        self._levels_next = False
        self._grown = []
        draw_fn = ((CONTEXT, "context_draws") if self.phase == "context"
                   else (QUANT, "_uniform"))
        faults = self.faults
        with contextlib.ExitStack() as stack:
            stack.enter_context(replaced(inputs, "orbit_poses",
                                         lambda _: lambda *_: self.poses))
            stack.enter_context(replaced(importlib.import_module(
                draw_fn[0]), draw_fn[1], self._keep_draws))
            stack.enter_context(replaced(importlib.import_module(STEP),
                                         "render", self._keep_levels))
            plant(stack, FAULTS, [f for f in faults
                                  if f not in densify.FAULTS])
            self.faults = [f for f in faults if f in densify.FAULTS]
            try:
                window = super().run(seconds, tracer)
            finally:
                self.faults = faults
        self.captured["depths"] = self._depths()
        self.captured["clamped"] = self._clamped()
        self._grown = []
        print(f"grown a depth [round, [depth 0, 1, 2]] in the set-up's "
              f"rounds and the checked one "
              f"({self.captured['round']['iteration']}): "
              f"{self.captured['depths']}; of the checked round's, "
              f"{self.captured['clamped']} outside the bounds",
              file=sys.stderr)
        return window

    # -- the checks ---------------------------------------------------------
    def _draws(self) -> list:
        """Each checked step's draws at the alive rows: the program's where
        the window kept them, else the reference's own over the pool."""
        kept = self.captured.get("draws")
        steps = self.traffic["checked_steps"]
        if kept:
            if self.phase == "context":
                return kept
            return [dict(zip(reference.NOISE_STREAMS, kept[3 * i:3 * i + 3]))
                    for i in range(steps)]
        g = torch.Generator(self.device).manual_seed(self.seed)
        n = self.state["alive"].shape[0]
        return [reference.rows_of(reference.draw(
            g, n, self.mcfg, self.phase, self.device), self.state["alive"])
            for _ in range(steps)]

    def _reference(self, tf32: bool) -> dict:
        cams = [raster.camera(r, t, fx, fy, self.device)
                for r, t, fx, fy in self.poses]
        return reference.follow(
            self.state, self.nets, self.mcfg, self.phase, cams, self.images,
            self.views, self._draws(), self.scales,
            self.traffic["spatial_lr_scale"],
            self.traffic["start_iteration"], self.device, tf32)

    def levels_off(self) -> int:
        """The pool slots whose level or parent, as the program's first
        step after a round at the checked round's iteration built them,
        differ from the reference's levels of that pool; every slot where
        no step followed such a round."""
        got = self.captured.get("levels")
        if got is None:
            return int(self.state["alive"].shape[0])
        rows = dict(got["pool"], alive=got["alive"],
                    bound_min=got["bound_min"], bound_max=got["bound_max"])
        want = reference.pool_levels(rows, self.mcfg, self.scales)
        off = ((got["level"].long() != want.level)
               | (got["parent"].long() != want.parent))
        return int(off.sum())

    def checks(self, control: bool = False) -> dict:
        out = super().checks(control)
        if not control and self.phase == "context":
            self.every["levels_off"] = self.levels_off()
            out["levels_off"] = (self.every["levels_off"],
                                 self.traffic["limits"]["levels_off"])
        return out


def _kept(kept: list):
    """`keep_draws` wrapped to keep what it draws in `kept`."""
    def wrap(draw):
        def drawn(*args, **kw):
            kept.append(draw(*args, **kw))
            return kept[-1]
        return drawn
    return wrap


def _context_rows(draws, alive: torch.Tensor, model) -> dict:
    """A step's `ContextDraws` at the alive rows, under the keys of the
    reference's `model.draw_noise`."""
    out = {"hyper": draws.hyper[alive].clone(),
           "rate": draws.rate[alive].clone()}
    for i in range(model.level_num):
        for s in md.STREAMS:
            out[(s, i)] = getattr(draws, s)[i][alive].clone()
    return out
