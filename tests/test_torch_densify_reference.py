"""The port's anchor-growing phase against the benchmark's plain reference
(`perfbench/reference/densify.py`, written from ContextGS's semantics, not
from the port), on the CPU at a small size: a pool of 512 slots with 300
alive anchors at the published widths (K 10, 3 depths). A round of
`adjust_anchors` with the reference's own draws gives the reference's
anchors bit for bit as a set, every field, Adam moment and statistic; a
pool that overflows places a part of the reference's growth; the
statistics and a plain-phase step agree; a round carries leader values
for the occupied-voxel grouping only; and a traced round records its spans
and counters."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import profile

from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch.models import densify as tdensify
from contextgs_tpu_torch.scene.cameras import make_camera
from contextgs_tpu_torch.scene.dataset_readers import SceneInfo
from contextgs_tpu_torch.train import loop as tloop
from contextgs_tpu_torch.train.optim import init_adam
from contextgs_tpu_torch.train.step import make_train_step
from contextgs_tpu_torch.utils import trace
from perfbench import inputs, program
from perfbench.kinds import densify as kind
from perfbench.reference import densify as reference
from perfbench.reference import model as md
from perfbench.reference import raster

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = dict(json.loads(
    (REPO / "perfbench/configs/tandt-100k.json").read_text()),
    anchors=300, width=64, height=48)
SLOTS = 512
CPU = torch.device("cpu")


def _round_inputs(seed, grow=True, prune=True, scattered=False,
                  slots=SLOTS):
    """(params, buffers, adam, draws): 300 anchors of the benchmark's
    recipe in a pool of `slots`, their offsets spread so that candidates
    leave the occupied voxels, statistics over 100 steps that pass the
    gradient threshold on one offset in 50 (`grow`) and prune a quarter of
    the anchors (`prune`), random Adam moments; with `scattered`, the free
    slots lie among the alive ones."""
    g = torch.Generator().manual_seed(seed)
    state = kind.pooled(inputs.anchor_state(CONFIG, seed, CPU), slots)
    if scattered:
        perm = torch.randperm(slots, generator=g)
        state = {f: x if f.startswith("bound_") else x[perm]
                 for f, x in state.items()}
    alive = state["alive"]
    n, k = state["offsets"].shape[:2]
    state["offsets"] = state["offsets"] * 10
    hi = torch.rand((n, k), generator=g) < (0.02 if grow else 0.0)
    live = alive[:, None].float()
    state["offset_denom"] = 100.0 * live.expand(n, k).contiguous()
    state["offset_grad_accum"] = torch.where(hi, 1.0, 1e-5) * 100.0 * live
    low = torch.rand(n, generator=g) < (0.25 if prune else 0.0)
    state["anchor_denom"] = 100.0 * alive.float()
    state["opacity_accum"] = torch.where(low, 0.0, 10.0) * alive.float()
    params, buffers = program.params(state, inputs.net_weights(CONFIG),
                                     CONFIG, CPU)
    adam = init_adam(params)
    for moments in (adam.mu, adam.nu):
        for f in md.ANCHOR_FIELDS:
            moments[f] = torch.randn(moments[f].shape, generator=g)
    draws = torch.rand((3, n * k), generator=g)
    return params, buffers, adam, draws


def _round(params, buffers, adam, draws):
    before = kind.pool_state(params, buffers, adam)
    res = tdensify.adjust_anchors(params, buffers, adam,
                                  program.model_config(CONFIG),
                                  tcfg.OptimizationConfig(),
                                  CONFIG["voxel_size"], draws=draws)
    return before, res, kind.pool_state(res.params, res.buffers, res.adam)


@pytest.mark.parametrize("case", [
    dict(grow=True, prune=False), dict(grow=False, prune=True),
    dict(grow=True, prune=True),
    dict(grow=True, prune=True, scattered=True)],
    ids=["growth", "pruning", "both", "scattered"])
def test_adjust_anchors_matches_the_reference(case):
    """The same draws on both sides: the program's alive anchors are the
    reference's as a set, every field, Adam moment and statistic bit for
    bit, with the same counts."""
    params, buffers, adam, draws = _round_inputs(7, **case)
    before, res, after = _round(params, buffers, adam, draws)
    prog, ref = kind.round_tables(before, draws, after, CONFIG)
    assert kind.rows_off(prog, ref) == 0
    assert prog.shape[0] == ref.shape[0]
    grown, pruned = int(res.n_grown), int(res.n_pruned)
    assert (grown > 0) == case["grow"] and (pruned > 0) == case["prune"]
    assert not bool(res.overflowed)
    assert int(after["alive"].sum()) == 300 + grown - pruned


def test_a_round_carries_only_the_occupied_voxels_grouping():
    """A round runs one carry a depth, the joint grouping of anchors and
    candidates that finds occupied voxels (N + N·K keys); the candidate
    grouping, which reads no leader value, runs none."""
    params, buffers, adam, draws = _round_inputs(7)
    n, k = params.offsets.shape[:2]
    trace.take()
    with profile():
        _round(params, buffers, adam, draws)
    carried = [c.n for c in trace.take().counts if c.name == "carry_keys"]
    assert carried == [n + n * k] * 3


def test_an_overflowing_pool_places_part_of_the_reference_growth():
    """Ten free slots for more growth: `overflowed` is set, every free slot
    is filled, and the program's anchors are a part of the reference's."""
    params, buffers, adam, draws = _round_inputs(11, prune=False,
                                                 slots=310)
    before, res, after = _round(params, buffers, adam, draws)
    prog, ref = kind.round_tables(before, draws, after, CONFIG)
    assert bool(res.overflowed) and int(res.n_grown) == 10
    assert ref.shape[0] > prog.shape[0] == 310
    assert kind.rows_off(prog, ref) == ref.shape[0] - prog.shape[0]


def test_accumulate_stats_matches_the_reference():
    g = torch.Generator().manual_seed(3)
    n, k = 300, 10
    stats = {s: torch.rand((n, k) if s.startswith("offset") else (n,),
                           generator=g) for s in reference.STATS}
    neural = torch.randn(n * k, generator=g)
    vis = torch.rand(n, generator=g) < 0.6
    valid = (neural > 0) & vis.repeat_interleave(k)
    keep = torch.rand(n * k, generator=g) < 0.8
    screen = torch.randn((n * k, 2), generator=g) * 1e-3
    buffers = tdensify.Buffers(alive=torch.ones(n, dtype=torch.bool),
                               bound_min=torch.zeros(1, 3),
                               bound_max=torch.ones(1, 3), **stats)
    got = tdensify.accumulate_stats(buffers, neural, valid, keep, vis, screen,
                                    k)
    gauss = md.Gaussians(None, None, torch.where(valid, neural, 0.0), None,
                         None, valid)
    want = reference.accumulate(stats, gauss, vis, keep, screen, k)
    for s in reference.STATS:
        torch.testing.assert_close(getattr(got, s), want[s], rtol=1e-6,
                                   atol=0.0)


def _cameras(n=3):
    out = []
    for i, (r, t, fx, fy) in enumerate(inputs.orbit_poses(
            dict(views=n, radius=4.0, fov_x=1.2), CONFIG["width"],
            CONFIG["height"])):
        out.append(((r, t, fx, fy), make_camera(
            i, r, t, fx, fy, CONFIG["width"], CONFIG["height"])))
    return out


def test_plain_step_matches_the_reference():
    """One plain-phase step with statistics: the loss, every leaf's
    gradient and the four statistics."""
    w, h = CONFIG["width"], CONFIG["height"]
    params, buffers, adam, _ = _round_inputs(5, grow=False, prune=False)
    state = kind.pool_state(params, buffers, adam)
    for s in reference.STATS:
        state[s] = torch.zeros_like(state[s])
    buffers = buffers._replace(**{s: state[s] for s in reference.STATS})
    adam = init_adam(params)
    nets = inputs.net_weights(CONFIG)
    pose, cam = _cameras()[1]
    gt = torch.rand((3, h, w), generator=torch.Generator().manual_seed(2))
    bg = torch.zeros(3)

    cfg = tcfg.TrainConfig(model=program.model_config(CONFIG))
    step = make_train_step(cfg, w, h, "plain", 4.4)
    _, got_b, got_adam, metrics = step(params, buffers, adam,
                                       cam.as_device_dict(), gt, bg, 1501,
                                       True)

    m = reference.alive_rows(state)
    m.update(nets)
    names = reference.param_names(m)
    leaves = {n: m[n].detach().requires_grad_(True) for n in names}
    nk = m["anchor"].shape[0] * 10
    screen = torch.zeros((nk, 2), requires_grad=True)
    image, gauss, vis, keep = reference.render(
        {**m, **leaves}, inputs.model_config(CONFIG),
        raster.camera(*pose, CPU), w, h, bg, screen)
    loss = reference.plain_loss(image, gt, gauss)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names] + [screen],
                                allow_unused=True)
    with torch.no_grad():
        want_stats = reference.accumulate(
            {s: m[s] for s in reference.STATS}, gauss, vis, keep, grads[-1],
            10)

    torch.testing.assert_close(metrics.loss, loss.detach(), rtol=1e-5,
                               atol=0.0)
    alive = state["alive"]
    for n, want in zip(names, grads[:-1]):
        got = got_adam.mu[n] / (1 - 0.9)
        if n in md.ANCHOR_FIELDS:
            got = got[alive]
        want = torch.zeros_like(got) if want is None else want
        scale = float(want.abs().max()) or 1.0
        assert float((got - want).abs().max()) <= 1e-4 * scale, n
    for s in reference.STATS:
        # the screen-space gradients differ by the order of float32 sums
        torch.testing.assert_close(
            getattr(got_b, s)[alive], want_stats[s], rtol=1e-4,
            atol=1e-5 * float(want_stats[s].abs().max()))


def test_a_traced_round_records_its_spans_and_counters():
    """A two-step run whose second step densifies, under the profiler: the
    round's span holds three growth depths, the pruning and the loop's one
    read-back, each wait inside a `sync/densify.*` span (or the anchor
    quantization's), and the counters hold the counts the loop read."""
    rng = np.random.default_rng(3)
    cams = [c for _, c in _cameras()]
    for c in cams:
        c.image = rng.uniform(0, 1, (c.height, c.width, 3)).astype(
            np.float32)
    pts = rng.uniform(-1.0, 1.0, (80, 3)).astype(np.float32)
    scene = SceneInfo(points=pts, colors=np.zeros_like(pts),
                      normals=np.zeros_like(pts), train_cameras=cams,
                      test_cameras=[], radius=2.0)
    cfg = tcfg.TrainConfig(
        model=dataclasses.replace(program.model_config(CONFIG),
                                  voxel_size=0.05, capacity_headroom=3.0),
        opt=tcfg.OptimizationConfig(iterations=2, start_stat=0,
                                    update_from=0, update_interval=2),
        log_every=1000, save_iterations=())
    first = []
    trace.take()
    with profile():
        ts = tloop.train(cfg, scene, device="cpu", callback=lambda it, ts, m:
                         first.append(tloop.st.n_alive(ts.model)))
    got = trace.take()
    by_id = {s.id: s for s in got.spans}
    rounds = [s for s in got.spans if s.name == "train/densify"]
    assert len(rounds) == 1 and rounds[0].parent is None

    def under(sid):
        while sid is not None:
            if sid == rounds[0].id:
                return True
            sid = by_id[sid].parent
        return False

    kids = {}
    for s in got.spans:
        if s.parent is not None and under(s.parent):
            key = (by_id[s.parent].name, s.name)
            kids[key] = kids.get(key, 0) + 1
    assert kids == {
        ("train/densify", "densify/grow"): 3,
        ("train/densify", "densify/prune"): 1,
        ("train/densify", "sync/densify.counts"): 1,
        ("densify/grow", "sync/quant.consts"): 3,
        ("densify/grow", "sync/densify.placed"): 3,
        ("densify/grow", "sync/densify.members"): 3,
        ("densify/grow", "sync/densify.unique"): 6}
    waits = {}
    for c in got.counts:
        if c.name == "syncs" and under(c.span):
            name = by_id[c.span].name
            waits[name] = waits.get(name, 0) + c.n
    assert waits == {"sync/quant.consts": 6, "sync/densify.placed": 3,
                     "sync/densify.members": 3, "sync/densify.unique": 6,
                     "sync/densify.counts": 1}
    counted = {c.name: c.n for c in got.counts
               if c.name.startswith("anchors_")}
    assert counted["anchors_grown"] - counted["anchors_pruned"] == \
        tloop.st.n_alive(ts.model) - first[0]
    assert set(counted) == {"anchors_grown", "anchors_pruned"}
    assert all(by_id[c.span].name == "train/densify" for c in got.counts
               if c.name.startswith("anchors_"))
