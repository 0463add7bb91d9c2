"""The row pack and the gradient regroup on the bench frame's real
instances (port of the root `scripts/pack_lab.py`).

The frame is `drivers.bench`'s: 200k seeded gaussians at 1280x720, the
JAX script's draws. It goes through the port's `project_gaussians` →
`expand_and_sort` → `splat_rows`. The JAX script times the pieces of its
static-shape pack (`_pack`: rows in depth order, one gather by the aligned
table `rank_aligned`, its transpose) and of its backward's segment
reduce; the port has no such table (K1 gathers its rows by `gauss_ids`
itself, K2 sums into `d_rows` with atomics), so the lab times what a port
that took those routes would run, under the JAX names:

- `prep16 (order gather + pads)`: the rows in depth order, padded to 16
  columns, plus a zero row;
- `gather16 [B]`: those rows gathered by instance, over the demand B (the
  port's dynamic list) where the JAX script gathers over its static
  `b_pad`; both sizes are printed;
- `gather16+T`: the same gather, transposed;
- the monotone fraction of the port's `gauss_ids`, which K1 gathers by,
  and of the depth ranks of the same instances, which the JAX package's
  `rank_aligned` holds (the lab computes its own depth order with the sort
  of `ops/rasterize/sorting.py`; `TileInstances` stays as it is);
- `regroup width 9` and `width 16`: per-instance gradient rows [B, w]
  (normal draws of `np.random.default_rng(1)`, as the JAX script's second
  generator, laid out [16, B] and taken row-major) summed per gaussian
  into [G, 9] three ways: a stable sort by gaussian, a cumsum down the
  rows, a gather at the segment bounds and the difference (the JAX
  regroup's route); the same route on the transposed [w, B] columns, its
  cumsum along the last axis (`lane scan`: torch's scan down the rows of
  [B, w] runs each of the w columns serially); and `index_add_` (K2's
  atomic route, in plain torch).

Each piece is timed by `scripts.time_ms` (CUDA events around 20
back-to-back calls after a warm-up on the card, the host clock on the
CPU), the table printed under the card's name and power limit. The JAX
script's static table `b_pad` is printed for comparison only.

    python -m contextgs_tpu_torch.scripts.pack_lab [--iters 20] [--force_cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import NamedTuple

import numpy as np
import torch

from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers import bench
from contextgs_tpu_torch.ops.rasterize import (TILE, TileInstances,
                                               expand_and_sort,
                                               project_gaussians, splat_rows)
from contextgs_tpu_torch.scripts import ITERS, card_line, time_ms
from contextgs_tpu_torch.scripts.r3_micro import LAMBDA, UNIT

W, H, G = 1280, 720, 200_000
PACK = 16
BUDGET, CHUNK = 768 * 1024, 128     # the JAX script's static table


class Frame(NamedTuple):
    rows: torch.Tensor         # [G, 9] splat rows
    order: torch.Tensor        # [G] int64 depth rank → gaussian
    rank: torch.Tensor         # [B] int64 depth rank of each instance
    inst: TileInstances        # the port's (tile, depth)-ordered instances
    grads: torch.Tensor        # [B, 16] per-instance gradient rows


def jax_table_size(n_tiles: int, budget: int = BUDGET,
                   align: int = CHUNK) -> int:
    """The JAX package's static instance table, `b_pad`, for a frame of
    `n_tiles` tiles (`padded_size` with its default slack)."""
    if n_tiles <= 512:
        slack = n_tiles * align
    else:
        slack = -(-(n_tiles * align * 5 // 8) // align) * align
    return budget + min(slack, n_tiles * align)


def frame(device, n_gauss: int = G, width: int = W,
          height: int = H) -> Frame:
    """The bench frame's instances and the lab's per-instance gradients."""
    means, scales, quats, colors, opac = bench.inputs(n_gauss, device)
    cam = bench.camera_kwargs(width, height, device)
    proj = project_gaussians(means, scales, quats, cam["world_view"],
                             cam["full_proj"], cam["tanfovx"],
                             cam["tanfovy"], width, height, TILE,
                             opacities=opac)
    inst = expand_and_sort(proj, -(-width // TILE), -(-height // TILE))
    # the depth order of ops/rasterize/sorting.py
    dkey = torch.where(proj.n_tiles > 0, proj.depths, float("inf"))
    order = torch.sort(dkey, stable=True).indices
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n_gauss, device=order.device)
    g16 = np.random.default_rng(1).normal(size=(PACK, inst.demand))
    grads = torch.from_numpy(g16.astype(np.float32).T.copy()).to(device)
    return Frame(rows=splat_rows(proj, colors, opac), order=order,
                 rank=inv_order[inst.gauss_ids.long()], inst=inst,
                 grads=grads)


def prep16(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """[G+1, 16]: the rows in depth order, zero-padded, and a zero row."""
    n, w = rows.shape
    rows16 = torch.cat([rows.index_select(0, order),
                        rows.new_zeros(n, PACK - w)], 1)
    return torch.cat([rows16, rows.new_zeros(1, PACK)])


def segment_bounds(ids: torch.Tensor, n: int) -> torch.Tensor:
    """[n + 1] int64: where each gaussian's instances start in the stable
    sort by gaussian, and their count at the end."""
    bounds = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    bounds[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
    return bounds


def regroup_sorted(g: torch.Tensor, ids: torch.Tensor,
                   n: int) -> torch.Tensor:
    """[n, 9] per-gaussian sums of the instance rows g [B, w] by a stable
    sort on the gaussian ids, a cumsum down the rows, a gather at the
    segment bounds and the difference (the JAX regroup's layout)."""
    _, perm = torch.sort(ids, stable=True)
    cs = torch.cat([g.new_zeros(1, g.shape[1]),
                    torch.cumsum(g.index_select(0, perm), 0)])
    at = cs.index_select(0, segment_bounds(ids, n))
    return (at[1:] - at[:-1])[:, :9]


def regroup_lanes(g: torch.Tensor, ids: torch.Tensor,
                  n: int) -> torch.Tensor:
    """[n, 9]: the same route on the instance columns g [w, B], the
    layout the JAX regroup starts from, its cumsum along the last axis."""
    _, perm = torch.sort(ids, stable=True)
    cs = torch.cat([g.new_zeros(g.shape[0], 1),
                    torch.cumsum(g.index_select(1, perm), 1)], 1)
    at = cs.index_select(1, segment_bounds(ids, n))
    return (at[:, 1:] - at[:, :-1])[:9].t()


def regroup_atomic(g: torch.Tensor, ids: torch.Tensor,
                   n: int) -> torch.Tensor:
    """[n, 9] per-gaussian sums of the instance rows by `index_add_`."""
    return g.new_zeros(n, g.shape[1]).index_add_(0, ids, g)[:, :9]


def regroup_tolerance(g: torch.Tensor, ids: torch.Tensor,
                      n: int) -> torch.Tensor:
    """float64 [n, 9]: a bound on |a float32 regroup − the exact
    per-gaussian sums| for each route above, from the instance values g
    ([B, w] or [w, B]) ordered by a stable sort on `ids`.

    The sort routes take c_b − c_a, two outputs of one scan (c the exact
    prefix sums of the sorted rows, gaussian j's instances a < k ≤ b).
    The roundings in which the two outputs differ are those of the adds
    between them in a sequential scan, the node sums of each end in a
    tree (see `r3_micro.cumsum_tolerance`), and the rounding of c_a;
    `index_add_` sums a segment of m values in any order, within
    λ·u·√m·Σ|g| (Higham and Mary). The bound is λ·u times
    sqrt(Σ_{a<k≤b} c_k²) + |c_a| + sqrt(L·Σ_{k≤a} g_k²)
    + sqrt(L·Σ_{k≤b} g_k²) + √m·Σ_{a<k≤b} |g_k|, λ = 8, L = ⌈log2(B+1)⌉."""
    g = (g if g.shape[0] == ids.numel() else g.t()).double()
    g = g[torch.sort(ids, stable=True).indices]
    zero = g.new_zeros(1, g.shape[1])
    c = torch.cat([zero, torch.cumsum(g, 0)])
    c2 = torch.cat([zero, torch.cumsum(c[1:] ** 2, 0)])
    g2 = torch.cat([zero, torch.cumsum(g * g, 0)])
    a1 = torch.cat([zero, torch.cumsum(g.abs(), 0)])
    bounds = segment_bounds(ids, n)
    a, b = bounds[:-1], bounds[1:]
    levels = math.ceil(math.log2(g.shape[0] + 1))
    m = (b - a).double()[:, None]
    scale = ((c2[b] - c2[a]).clamp(min=0).sqrt() + c[a].abs()
             + (levels * g2[a]).sqrt() + (levels * g2[b]).sqrt()
             + m.sqrt() * (a1[b] - a1[a]))
    return (LAMBDA * UNIT * scale)[:, :9]


def monotone_fraction(x: torch.Tensor) -> float:
    """The share of neighbours in `x` that increase: an exact count over
    the pairs, so that every device gives the same float."""
    n = x.numel() - 1
    return int((x[1:] > x[:-1]).sum()) / n if n > 0 else 0.0


def pieces(f: Frame) -> list:
    """[(name, fn, inputs)] under the JAX script's names, each regroup
    three times (the sort route with its cumsum down the rows, the same
    route along the lanes of [w, B], then `index_add_`)."""
    rows_rank = prep16(f.rows, f.order)
    n = f.rows.shape[0]
    ids = f.inst.gauss_ids
    out = [("prep16 (order gather + pads)", prep16, (f.rows, f.order)),
           ("gather16 [B]", lambda r, a: r.index_select(0, a),
            (rows_rank, f.rank)),
           ("gather16+T", lambda r, a: r.index_select(0, a).t().contiguous(),
            (rows_rank, f.rank))]
    for w in (9, 16):
        g = f.grads[:, :w].contiguous()
        out += [(f"regroup width {w}",
                 lambda g, i: regroup_sorted(g, i, n), (g, ids)),
                (f"regroup width {w} (lane scan)",
                 lambda g, i: regroup_lanes(g, i, n),
                 (g.t().contiguous(), ids)),
                (f"regroup width {w} (index_add_)",
                 lambda g, i: regroup_atomic(g, i, n), (g, ids))]
    return out


def measure(device, iters: int = ITERS) -> dict:
    """{"demand", "b_pad", "monotone": {...}, "ms": {piece: ms}} on the
    bench frame, the table printed as it goes."""
    device = torch.device(device)
    f = frame(device)
    tiles = -(-W // TILE) * -(-H // TILE)
    res = dict(demand=f.inst.demand, b_pad=jax_table_size(tiles),
               monotone=dict(gauss_ids=monotone_fraction(f.inst.gauss_ids),
                             depth_rank=monotone_fraction(f.rank)), ms={})
    print(card_line() if device.type == "cuda" else "cpu", flush=True)
    print(f"demand B {res['demand']} (the JAX package's static table "
          f"b_pad {res['b_pad']})", flush=True)
    print(f"monotone frac: gauss_ids {res['monotone']['gauss_ids']:.6f}, "
          f"depth ranks {res['monotone']['depth_rank']:.6f}", flush=True)
    for name, fn, xs in pieces(f):
        res["ms"][name] = time_ms(lambda: fn(*xs), device, iters)
        print(f"{name:40s} {res['ms'][name]:8.3f} ms", flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--force_cpu", action="store_true",
                   help="time the pieces on the CPU by the host clock; "
                        "without it they run on the CUDA card, and the "
                        "script raises where there is none")
    args = p.parse_args(argv)
    measure(resolve_device("cpu" if args.force_cpu else None), args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
