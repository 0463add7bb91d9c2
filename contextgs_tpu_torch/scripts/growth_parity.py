"""Matched-state densify growth parity: one process against N ranks (port of
the root `scripts/growth_parity.py`).

A sharded run's trajectory parts from a single process's from its first
step (band-local SSIM, each rank's own draws), so cumulative anchor counts
confound growth mechanics with trajectory drift. This removes the
confound: ONE `adjust_anchors` on the IDENTICAL seeded mid-training state,
single process against `parallel/sharded.make_sharded_densify` on N ranks
plus the host `reshard_anchors` dedup the sharded loop always runs after
it, repeated over several keys. Each key's keep draws are made once; the
single call takes them, and the ranks take the same numbers, moved with
their anchors through the reshard's row plan, so a delta measures growth
and not generators.

    python -m contextgs_tpu_torch.scripts.growth_parity [--devices 8] \\
        [--points 20000] [--keys 5] [--force_cpu]

On the CPU (`--force_cpu`) the ranks run gloo; on cards, NCCL where there
are as many cards as ranks, else the ranks share the cards over gloo (NCCL
refuses two ranks on one device).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from contextgs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                        TrainConfig)
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.models import densify as dn, state as st
from contextgs_tpu_torch.parallel import comm
from contextgs_tpu_torch.parallel.sharded import (_anchor_tensors,
                                                  _with_anchor_tensors,
                                                  gather_model,
                                                  make_sharded_densify,
                                                  reshard_rows, shard_model,
                                                  take_rows)
from contextgs_tpu_torch.train.optim import init_adam

TIMEOUT_S = 900        # seconds the ranks may take


def config() -> TrainConfig:
    """The JAX script's overrides: small widths, a pool with headroom."""
    return TrainConfig(
        model=ModelConfig(feat_dim=8, n_offsets=4, voxel_size=0.01,
                          capacity_headroom=4.0),
        opt=OptimizationConfig(update_interval=100, success_threshold=0.8,
                               densify_grad_threshold=0.0002))


def seeded_state(cfg: TrainConfig, points: int):
    """The JAX script's seeded mid-training state, on the host: `points`
    uniform SfM points, offsets N(0, 2), and on a random ~20% of offsets
    heavy-tailed gradient statistics over 100 observations.
    → (params, buffers, adam, voxel_size)."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 1, (points, 3)).astype(np.float32)
    model, voxel = st.init_scene_model(
        pts, cfg.model, generator=torch.Generator().manual_seed(0),
        device="cpu")
    p, b = model.params, model.buffers
    n, k = b.offset_grad_accum.shape
    g = (rng.random((n, k)) < 0.2) * rng.lognormal(-7.5, 1.0, (n, k))
    p = p._replace(offsets=torch.from_numpy(
        rng.normal(0, 2.0, (n, k, 3)).astype(np.float32)))
    alive = b.alive.numpy()

    def put(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    b = b._replace(
        offset_grad_accum=put(np.where(alive[:, None], g * 100.0, 0.0)),
        offset_denom=put(np.where(alive[:, None], 100.0, 0.0)
                         * np.ones((n, k))),
        opacity_accum=put(np.where(alive, 100.0, 0.0)),
        anchor_denom=put(np.where(alive, 100.0, 0.0)))
    return p, b, init_adam(p), voxel


def key_draws(cfg: TrainConfig, nk: int, keys: int) -> list:
    """Each key's keep draws, [update_depth, N·K], made once from a
    generator seeded 1000 + key (the JAX script's `PRNGKey(1000 + key)`)."""
    return [dn.keep_draws(torch.Generator().manual_seed(1000 + ki),
                          cfg.model.update_depth, nk, "cpu")
            for ki in range(keys)]


def _copy(params, buffers, adam, dev):
    """A private copy of a host state on `dev`: densify writes the anchor
    fields and the Adam moments in place."""
    params = params._replace(**{f: getattr(params, f).to(dev, copy=True)
                                for f in st.ANCHOR_FIELDS})
    buffers = type(buffers)(*(x.to(dev, copy=True) for x in buffers))
    adam = type(adam)(mu={k: x.to(dev, copy=True) for k, x in adam.mu.items()},
                      nu={k: x.to(dev, copy=True) for k, x in adam.nu.items()},
                      count=adam.count)
    return params, buffers, adam


def single_growth(cfg: TrainConfig, state, draws: torch.Tensor,
                  device) -> tuple[int, bool]:
    """One single-process `adjust_anchors` with `draws` on `device`:
    (anchors grown net of the pruned, overflowed)."""
    params, buffers, adam, voxel = state
    dev = resolve_device(device)
    n0 = int(buffers.alive.sum())
    res = dn.adjust_anchors(*_copy(params, buffers, adam, dev), cfg.model,
                            cfg.opt, voxel, draws=draws.to(dev))
    return int(res.buffers.alive.sum()) - n0, bool(res.overflowed)


def rank_draws(draws: torch.Tensor, src: np.ndarray, n_dev: int,
               k: int) -> list:
    """The single call's draws moved with their anchors through the
    reshard's row plan `src` (pad rows take 1.0; they are dead), cut into
    the ranks' slabs: [update_depth, N'/n_dev·K] a rank."""
    depth = draws.shape[0]
    per_slot = draws.reshape(depth, -1, k)
    rows = torch.from_numpy(np.where(src < 0, 0, src))
    moved = per_slot[:, rows]
    moved[:, torch.from_numpy(src < 0)] = 1.0
    return list(moved.reshape(depth, -1).chunk(n_dev, dim=1))


def _densify_rank(mesh, job: dict) -> dict | None:
    """Rank body: for each key, this rank's slab of the resharded state,
    one sharded densify with the key's draws for this rank, the slabs
    gathered. Rank 0 returns each key's gathered anchor-indexed tensors and
    the overflow flag."""
    out = []
    for draws in job["draws"]:
        # shard_model copies the rows: each key starts from the same state
        sp, sb, sa = shard_model(mesh, job["params"], job["buffers"],
                                 job["adam"])
        res = make_sharded_densify(job["cfg"], mesh, job["voxel"])(
            sp, sb, sa, draws=draws[mesh.rank].to(mesh.device))
        full = gather_model(mesh, res.params, res.buffers, res.adam)
        out.append(dict(tensors=_anchor_tensors(*full),
                        overflowed=bool(res.overflowed)))
    return out if mesh.rank == 0 else None


def mesh_growth(cfg: TrainConfig, state, draws: list, n_dev: int, device,
                per_rank: list | None = None) -> list:
    """Per key of `draws`: the sharded densify on `n_dev` ranks from the
    resharded state, then the host dedup. Each rank takes the key's draws
    moved through the reshard (`rank_draws`), or `per_rank[key][rank]`
    where given. → [dict(mesh_raw, mesh_dedup, overflowed)] (anchors net
    of n0 before and after the dedup)."""
    params, buffers, adam, voxel = state
    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and n_dev <= torch.cuda.device_count() else "gloo")
    n0 = int(buffers.alive.sum())
    src, _ = reshard_rows(params, buffers, n_dev, voxel)
    hp, hb, ha = take_rows(params, buffers, adam, src)
    if per_rank is None:
        per_rank = [rank_draws(d, src, n_dev, cfg.model.n_offsets)
                    for d in draws]
    job = dict(cfg=cfg, params=hp, buffers=hb, adam=ha, voxel=voxel,
               draws=per_rank)
    results = comm.spawn(_densify_rank, n_dev, (job,), backend=backend,
                         device_type=dev.type, timeout=TIMEOUT_S)[0]
    rows = []
    for res in results:
        fp, fb, _ = _with_anchor_tensors(hp, hb, ha, res["tensors"])
        _, info = reshard_rows(fp, fb, n_dev, voxel)
        rows.append(dict(mesh_raw=int(fb.alive.sum()) - n0,
                         mesh_dedup=info["n_alive"] - n0,
                         overflowed=res["overflowed"]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--keys", type=int, default=5)
    ap.add_argument("--force_cpu", action="store_true",
                    help="the single call and the ranks on the CPU (gloo)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.force_cpu else None)

    cfg = config()
    state = seeded_state(cfg, args.points)
    n0 = int(state[1].alive.sum())
    draws = key_draws(cfg, state[0].offsets.shape[0] * cfg.model.n_offsets,
                      args.keys)
    mesh = mesh_growth(cfg, state, draws, args.devices, dev)

    print(f"{'key':>4} {'single':>8} {'mesh_raw':>9} {'mesh_dedup':>10} "
          f"{'delta%':>7}")
    deltas = []
    for ki, (d, m) in enumerate(zip(draws, mesh)):
        single, overflowed = single_growth(cfg, state, d, dev)
        if overflowed or m["overflowed"]:
            raise RuntimeError(f"key {ki}: anchor pool overflow (single "
                               f"{overflowed}, sharded {m['overflowed']}); "
                               "raise capacity_headroom")
        delta = 100.0 * (m["mesh_dedup"] - single) / max(single, 1)
        deltas.append(delta)
        print(f"{ki:>4} {single:>8} {m['mesh_raw']:>9} "
              f"{m['mesh_dedup']:>10} {delta:>6.1f}%")
    print(f"mean delta {np.mean(deltas):+.1f}%  (n0={n0}, "
          f"{args.devices} devices)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
