"""The reference's quantization of a scene state, as ContextGS's codec stores
it: the kept anchors' 16-bit codes, the rounded hyper latents, the offset
masks, and per level from the coarsest the features, scalings and kept
offsets rounded to the Q that the level's grid MLP predicts from the
already-quantized parents (`model.predict`, over every kept anchor).

A decoder is right where every anchor code, hyper symbol and mask comes
back exactly, and every other value is a whole number of the predicted Q
that lies within half a Q of the value it codes (`gaps`): the Q is the
model's prediction, which two implementations compute equal only to a few
units in the last place.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as md

HYPER_RANGE = 1 << 16      # the codec's clamp of the hyper symbols


def _symbols(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """round(clip(x, ±15000·Q) / Q) in float64."""
    x = np.clip(x, -md.CLAMP_STEPS * q, md.CLAMP_STEPS * q)
    return np.round(x.astype(np.float64) / q).astype(np.int64)


@torch.no_grad()
def coding_context(m: dict, model: md.Model, level_scales, device) -> dict:
    """What the codec codes before the levels, and the levels: the kept
    rows `idx`, the anchors on their grid, the hyper symbols, the masks,
    and the level hierarchy of the decoded anchors."""
    keep = md.kept_anchors(m)
    idx = torch.nonzero(keep).squeeze(1)
    n = int(idx.numel())

    def kept(x):
        return x.index_select(0, idx).cpu().numpy()

    bmin = m["bound_min"].cpu().numpy()
    bmax = m["bound_max"].cpu().numpy()
    interval = (bmax - bmin) * md.Q_ANCHOR + 1e-6
    codes = np.clip(np.floor((kept(m["anchor"]) - bmin) / interval), 0,
                    2 ** md.ANCHOR_BITS - 1).astype(np.uint16)
    anchor = (codes.astype(np.float32) * interval.astype(np.float32)
              + bmin.astype(np.float32))
    hyper = np.clip(np.round(kept(m["hyper_latent"])), -(HYPER_RANGE // 2),
                    HYPER_RANGE // 2).astype(np.int64)
    anchor_q = torch.from_numpy(anchor).to(device)
    levels = md.build_levels(anchor_q, torch.ones(n, dtype=torch.bool,
                                                  device=device),
                             model.voxel_size, level_scales, model.level_num)
    return dict(idx=idx, n=n, kept=kept, anchor=anchor, hyper=hyper,
                masks=kept(md.offset_mask(m)), anchor_q=anchor_q,
                levels=levels, level=levels.level.cpu().numpy(),
                hyper_ctx=torch.from_numpy(hyper.astype(np.float32))
                .to(device))


@torch.no_grad()
def level_chain(ctx: dict, m: dict, model: md.Model, device, values):
    """Run the levels from the coarsest: for each, the grid MLP's μ and Q
    of every kept anchor from the already-quantized parents, then
    `values(level rows, {stream: (μ, Q) [rows, width]})` gives the rows'
    values of each stream, whose quantization becomes the context of the
    finer levels. Yields (rows, {stream: (symbols, Q, values)})."""
    n = ctx["n"]
    widths = md.stream_widths(model)
    coded = {s: torch.zeros((n, w), dtype=torch.float32, device=device)
             for s, w in widths.items()}
    on3 = np.repeat(ctx["masks"], 3, axis=1).astype(bool)
    for i in reversed(range(model.level_num)):
        rows = np.where(ctx["level"] == i)[0]
        rows_t = torch.from_numpy(rows).to(device)
        e = md.predict(m, model, i, md.level_input(
            model, i, ctx["anchor_q"], coded, ctx["levels"],
            ctx["hyper_ctx"]))
        pred = {s: (e.mean[s][rows_t].cpu().numpy(),
                    np.repeat(e.q[s][rows_t].cpu().numpy(), w, axis=1))
                for s, w in widths.items()}
        x = values(rows, pred)
        out = {}
        for s in md.STREAMS:
            q = pred[s][1]
            sym = _symbols(x[s], q)
            if s == "offsets":
                sym = np.where(on3[rows], sym, 0)
            out[s] = (sym, q, x[s])
            coded[s][rows_t] = torch.from_numpy(
                sym.astype(np.float32) * q).to(device)
        yield rows, out


@torch.no_grad()
def quantize(state: dict, nets: dict, model: md.Model, level_scales, device,
             tf32: bool = False) -> dict:
    """{"anchor": dequantized kept anchors [n,3] float32, "hyper": [n,Fh]
    symbols, "masks": [n,K] {0,1}, and per stream ("feat", "scaling",
    "offsets"): "<s>_sym" [n,w] symbols, "<s>_q" [n,w] steps and "<s>_x"
    [n,w] the values coded, the masked offsets' symbols zero}."""
    from perfbench.reference.train import precision

    m = dict(state)
    m.update({k: v.to(device) for k, v in nets.items()})
    ctx = coding_context(m, model, level_scales, device)
    n, kept = ctx["n"], ctx["kept"]
    values = dict(feat=kept(m["anchor_feat"]),
                  scaling=np.exp(kept(m["scaling_log"])),
                  offsets=kept(m["offsets"]).reshape(n, -1))
    out = dict(anchor=ctx["anchor"], hyper=ctx["hyper"],
               masks=ctx["masks"].astype(np.int32).astype(np.float32))
    for s, w in md.stream_widths(model).items():
        for part, dtype in (("sym", np.int64), ("q", np.float32),
                            ("x", np.float32)):
            out[f"{s}_{part}"] = np.zeros((n, w), dtype)
    with precision(tf32):
        for rows, coded in level_chain(
                ctx, m, model, device,
                lambda rows, _: {s: values[s][rows] for s in md.STREAMS}):
            for s, (sym, q, x) in coded.items():
                out[f"{s}_sym"][rows] = sym
                out[f"{s}_q"][rows] = q
                out[f"{s}_x"][rows] = x
    return out


def gaps(decoded: dict, ref: dict) -> tuple:
    """(codes_off, symbol_gap) of a decoded scene (numpy arrays: anchor,
    hyper, masks, feat, scaling, offsets [n,3K]) against the reference's
    quantization. codes_off: the anchors, hyper symbols and masks that
    differ. symbol_gap: the largest, over every other value d with the
    reference's step Q and coded value x clamped to ±15000·Q, of d/Q's
    distance to a whole number and of |d - x|/Q's excess over 1/2; for a
    masked offset, |d|/Q."""
    off = 0
    for name in ("anchor", "hyper", "masks"):
        a, b = decoded[name], ref[name]
        if a.shape != b.shape:
            return float(max(a.size, b.size)), float("inf")
        off += int((a != b).sum())
    worst = 0.0
    on3 = np.repeat(ref["masks"], 3, axis=1).astype(bool)
    for s in md.STREAMS:
        q = ref[f"{s}_q"].astype(np.float64)
        d = decoded[s].astype(np.float64)
        if d.shape != q.shape:
            return float(off), float("inf")
        x = np.clip(ref[f"{s}_x"].astype(np.float64), -md.CLAMP_STEPS * q,
                    md.CLAMP_STEPS * q)
        r = d / q
        gap = np.maximum(np.abs(r - np.round(r)),
                         np.abs(d - x) / q - 0.5)
        if s == "offsets":
            gap = np.where(on3, gap, np.abs(r))
        worst = max(worst, float(gap.max(initial=0.0)))
    return float(off), worst
