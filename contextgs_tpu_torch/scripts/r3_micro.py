"""Glue costs at fixed synthetic shapes (port of the root
`scripts/r3_micro.py`): a transpose, row gathers, cumsums, sorts and
scatters of the sizes the bench frame's binning and gradient regroup
handle, each timed alone.

The inputs are the JAX script's, drawn from `np.random.default_rng(0)` in
its order (g16, perm, seg, inv, gRM, gD, cs, pr, rows, ra, keys, pay,
offs, vals, hv; the script draws some of them between its timings, and
the order fixes the data): B_PAD = 1,074,432 (the JAX package's static
instance table at the bench frame), B = 786,432, G = 200,000, rows of 16
float32, 1,247,232 sort keys. Each piece keeps the JAX script's name;
its torch counterpart:

    g.T behind a barrier             g.t().contiguous()
    g[p]                             g.index_select(0, p)
    jnp.cumsum(g, axis=0)            torch.cumsum(g, 0)
    lax.sort((k, p), unstable)       torch.sort(k, stable=False), then the
                                     payload gathered by its indices; the
                                     sort and the gather are also timed
                                     apart (": sort", ": payload gather")
    .at[o].add(mode="drop")          index_add_ (the offsets are < B by
                                     construction: nothing is dropped)
    int32 cumsum                     torch.cumsum(..., dtype=torch.int32)

The u32 keys go to torch as int32 with the sign bit flipped (k ^ 2^31
viewed as int32), which keeps their unsigned order at the same bytes;
`unsigned_keys` turns them back. Each piece is timed by
`scripts.time_ms`: CUDA events around 20 back-to-back calls after one
warm-up call on the card (the card's time a call, the host's launch gaps
included), the host clock on the CPU. Eager launches on one stream run in
order, so the JAX script's chained `x + 1e-30·c` loop, which only keeps
XLA from removing the work, has no counterpart. The table is printed
under the card's name and power limit (`nvidia-smi`).

    python -m contextgs_tpu_torch.scripts.r3_micro [--iters 20] [--force_cpu]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.scripts import ITERS, card_line, time_ms

B_PAD = 1_074_432
B = 786_432
G = 200_000
PACK = 16
B_FULL = B + 3600 * 128
SIGN = np.int32(-2 ** 31)
UNIT = 2.0 ** -24      # float32's unit roundoff
LAMBDA = 8.0           # a tolerance's multiple of its rounding scale


def cumsum_tolerance(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """float64, shaped as `x`: a bound on |float32 cumsum(x) − the exact
    prefix sums| along `dim` at each output i, for a sequential, a tree or
    a chunked scan.

    Each addition rounds the partial sum p it forms by (1 + δ), |δ| ≤ u =
    2^-24, so the error at i is about Σ δ·p over the partials formed for
    i. A sequential scan's partials are the prefix sums s_k, k ≤ i; a
    tree's are block sums, whose squares add up to about L·Σ_{k≤i} x_k²
    (L = ⌈log2(n + 1)⌉ levels) for zero-mean draws; a chunked scan has
    both. With independent δ (Higham and Mary's model of rounding) the
    error stays within λ·u·sqrt(Σ p²) with probability at least
    1 − 2·exp(−λ²/2) (Azuma–Hoeffding), so the bound is
    λ·u·(sqrt(Σ_{k≤i} s_k²) + sqrt(L·Σ_{k≤i} x_k²)), λ = 8: 2.5e-14 an
    output. It is about 0.3% of the values at the end of the lab's
    786,432 rows of N(0, 1) draws, below the |x| that a scan shifted by
    one row is off by."""
    x = x.double()
    s = torch.cumsum(x, dim)
    levels = math.ceil(math.log2(x.shape[dim] + 1))
    return LAMBDA * UNIT * (torch.cumsum(s * s, dim).sqrt()
                            + (levels * torch.cumsum(x * x, dim)).sqrt())


def signed_keys(keys: np.ndarray) -> np.ndarray:
    """u32 keys as int32 in the same order: the sign bit flipped."""
    return keys.view(np.int32) ^ SIGN


def unsigned_keys(keys) -> np.ndarray:
    """The inverse of `signed_keys`, from a tensor or an array."""
    return (np.asarray(keys.cpu() if torch.is_tensor(keys) else keys)
            ^ SIGN).view(np.uint32)


def draws() -> dict:
    """The JAX script's inputs as numpy arrays, drawn in its order."""
    rng = np.random.default_rng(0)
    f32, i32 = np.float32, np.int32
    d = {}
    d["g16"] = rng.normal(size=(PACK, B_PAD)).astype(f32)
    d["perm"] = rng.permutation(B_PAD)[:B].astype(i32)
    seg = np.sort(rng.integers(0, B, G + 1)).astype(i32)
    seg[0], seg[-1] = 0, B
    d["seg"] = seg
    d["inv"] = rng.permutation(G).astype(i32)
    d["gRM"] = rng.normal(size=(B_PAD + 1, PACK)).astype(f32)
    d["gD"] = rng.normal(size=(B, PACK)).astype(f32)
    d["cs"] = rng.normal(size=(B + 1, PACK)).astype(f32)
    d["pr"] = rng.normal(size=(G, PACK)).astype(f32)
    d["rows"] = rng.normal(size=(G + 1, PACK)).astype(f32)
    d["ra"] = rng.integers(0, G + 1, B_PAD).astype(i32)
    d["keys"] = rng.integers(0, 2 ** 31, B_FULL, np.int64).astype(np.uint32)
    d["pay"] = rng.integers(0, G, B_FULL).astype(i32)
    d["offs"] = np.sort(rng.integers(0, B, G)).astype(i32)
    d["vals"] = rng.integers(0, 2 ** 30, G).astype(i32)
    d["hv"] = rng.integers(0, 3, B).astype(i32)
    return d


def sort_with_payload(k: torch.Tensor, p: torch.Tensor) -> tuple:
    """(keys in ascending order, the payload in the same order); unstable,
    as the JAX script's sort."""
    s = torch.sort(k, stable=False)
    return s.values, p.index_select(0, s.indices)


def ffill(v: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The per-slot forward fill of `v` from the sorted heads `o`: value
    deltas added at the heads, then an int32 cumsum."""
    d = v - torch.cat([v.new_zeros(1), v[:-1]])
    heads = v.new_zeros(B).index_add_(0, o, d)
    return torch.cumsum(heads, 0, dtype=torch.int32)


def pieces(device) -> list:
    """[(name, fn, inputs)] in the JAX script's order, under its names,
    with the ": sort" and ": payload gather" halves of each sort after
    it; `fn(*inputs)` is the piece."""
    d = draws()
    d["keys"] = signed_keys(d["keys"])
    d = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    keys = d["keys"]
    presorted = torch.sort(keys).values
    iota = torch.arange(B_FULL, dtype=torch.int32, device=device)
    out = [
        ("xpose [16,Bp]->[Bp,16] (barrier)",
         lambda g: g.t().contiguous(), (d["g16"],)),
        ("perm row-gather [B from Bp+1,16]",
         lambda g, p: g.index_select(0, p), (d["gRM"], d["perm"])),
        ("cumsum [B,16] axis0", lambda g: torch.cumsum(g, 0), (d["gD"],)),
        ("boundary gather [G+1 from B+1,16]",
         lambda c, s: c.index_select(0, s), (d["cs"], d["seg"])),
        ("inv_order gather [G,16]",
         lambda p, i: p.index_select(0, i)[:, :9], (d["pr"], d["inv"])),
        ("pack row-gather [Bp from G+1,16]",
         lambda r, a: r.index_select(0, a), (d["rows"], d["ra"])),
        ("pack gather + .T barrier",
         lambda r, a: r.index_select(0, a).t().contiguous(),
         (d["rows"], d["ra"]))]
    for name, k, p in (("sort u32 [1.25M] + 1 payload", keys, d["pay"]),
                       ("sort PRESORTED u32 [1.25M] + 1 payload", presorted,
                        d["pay"]),
                       ("inversion sort [1.25M] (i32 key + iota)", d["pay"],
                        iota)):
        idx = torch.sort(k, stable=False).indices
        out += [(name, sort_with_payload, (k, p)),
                (f"{name}: sort",
                 lambda k: tuple(torch.sort(k, stable=False)), (k,)),
                (f"{name}: payload gather",
                 lambda p, i: p.index_select(0, i), (p, idx))]
    out += [
        ("ffill scatter+cumsum (1 word)", ffill, (d["vals"], d["offs"])),
        ("scatter 200k->786k",
         lambda v, o: v.new_zeros(B).index_add_(0, o, v),
         (d["vals"], d["offs"])),
        ("cumsum [786k] i32",
         lambda h: torch.cumsum(h, 0, dtype=torch.int32), (d["hv"],))]
    return out


def measure(device, iters: int = ITERS) -> dict:
    """{piece name: ms a call}, the table printed as it goes."""
    device = torch.device(device)
    print(card_line() if device.type == "cuda" else "cpu", flush=True)
    times = {}
    for name, fn, xs in pieces(device):
        times[name] = time_ms(lambda: fn(*xs), device, iters)
        print(f"{name:58s} {times[name]:8.3f} ms", flush=True)
    return times


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
