"""The numbers that decide `correct`, each a gap between what the program
produced and what the plain reference produces from the same inputs."""

from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone, and its change is not compared
NEGLIGIBLE_GRAD = 1e-3


def relative_gap(prog: list, ref: list) -> float:
    """The largest |prog − ref| / |ref| over paired values."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gaps(prog: dict, ref: dict, names=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = list(ref) if names is None else list(names)
    nonzero = [ref[n] for n in names if ref[n] > 0]
    med = statistics.median(nonzero) if nonzero else 0.0
    out = {}
    for n in names:
        scale = max(ref[n], med)
        if scale == 0.0:
            out[n] = 0.0 if prog[n] == 0.0 else float("inf")
        else:
            out[n] = abs(prog[n] - ref[n]) / scale
    return out


def leaf_gap(prog: dict, ref: dict, names=None) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, names).values(), default=0.0)


def worst_leaves(prog: dict, ref: dict, names=None, k: int = 3) -> list:
    """[name, gap, program's norm, reference's norm] of the `k` leaves
    with the largest gaps."""
    gaps = leaf_gaps(prog, ref, names)
    return [[n, g, prog[n], ref[n]] for n, g in
            sorted(gaps.items(), key=lambda x: -x[1])[:k]]


def moved_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient is not negligible."""
    nonzero = [v for v in ref_grad.values() if v > 0]
    if not nonzero:
        return []
    floor = NEGLIGIBLE_GRAD * statistics.median(nonzero)
    return [n for n, v in ref_grad.items() if v >= floor]


def inside_leaf(g_prog, g_ref, d_prog, d_ref) -> dict:
    """The look inside one leaf: its elements split by the reference's
    first gradient, `small` (under a thousandth of the leaf's median
    |gradient|) against the rest, with each part's share of the elements,
    the share whose first gradients differ in sign, and the gap between the
    norms of the program's and the reference's change over that part, as
    a share of the reference's change over the whole leaf."""
    g_prog, g_ref = g_prog.double().flatten(), g_ref.double().flatten()
    d_prog, d_ref = d_prog.double().flatten(), d_ref.double().flatten()
    scale = float(torch.linalg.vector_norm(d_ref)) or 1.0
    small = g_ref.abs() < NEGLIGIBLE_GRAD * g_ref.abs().median()
    out = {"elements": int(g_ref.numel())}
    for name, part in (("small", small), ("rest", ~small)):
        n = int(part.sum())
        out[name] = {
            "share": n / max(g_ref.numel(), 1),
            "sign_differs": (float(((g_prog[part] > 0) != (g_ref[part] > 0))
                                   .double().mean()) if n else 0.0),
            "change_gap": abs(float(torch.linalg.vector_norm(d_prog[part]))
                              - float(torch.linalg.vector_norm(d_ref[part])))
            / scale}
    return out


def step_gaps(g_prog: list, g_ref: list) -> list:
    """For each step: the program's gradient's distance from the
    reference's as a share of the reference's norm, and the cosine between
    the reference's gradient of that step and of the first."""
    first = g_ref[0].double().flatten()
    out = []
    for p, r in zip(g_prog, g_ref):
        p, r = p.double().flatten(), r.double().flatten()
        norm = float(torch.linalg.vector_norm(r)) or 1.0
        cos = float(r @ first) / (norm * (float(
            torch.linalg.vector_norm(first)) or 1.0))
        out.append({"grad_gap": float(torch.linalg.vector_norm(p - r)) / norm,
                    "cos_to_first": cos})
    return out


def image_gaps(prog: list, ref: list) -> tuple:
    """(largest |pixel difference|, largest mean |pixel difference| of a
    view) over paired [3,H,W] images."""
    worst_max, worst_mean = 0.0, 0.0
    for p, r in zip(prog, ref):
        d = (p.to(torch.float64) - r.to(torch.float64)).abs()
        worst_max = max(worst_max, float(d.max()))
        worst_mean = max(worst_mean, float(d.mean()))
    return worst_max, worst_mean
