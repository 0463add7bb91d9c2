"""Bitstream encoder and decoder (port of
`contextgs_tpu/compression/codec.py`): trained scene → compressed files →
`DecodedScene` on the device.

The files are the JAX package's, file for file: anchor.npy (raw uint16
codes), hyper.b (factorized-prior streams, one a channel), masks.b
(Bernoulli), feat{L}.b / scaling{L}.b / offsets{L}.b per level
(conditional-gaussian streams in 1000-anchor chunks, each chunk's window and
lengths in the metadata), meta.pkl (Python and numpy objects only) and
mlp.pkl (`utils/checkpoint.save_pytree`).

Determinism: the level maps (`levels.build_level_maps`) and the per-level
μ, σ and Q (`context.make_level_predictor`) run in torch on the device over
the same n rows on both sides. The reference pads its rows to a power of two
for XLA's compile cache only (pad rows join no level and are never coded);
torch has no such cache, so neither side pads. μ, σ and Q reach the host as
float32 (`_ep_host`) and the CDF rows are built from them by one function
(`_cdf_rows`) for both sides, so encode∘decode is lossless and the
autoregressive chain bit-identical on one device. Decoding the other
package's files needs the same μ, σ and Q to the bit.

`_cdf_rows` builds the rows where the codec's device is: in host float64
with scipy's `ndtr` (the plain version, `_windowed_cdf_rows` and
`coder.quantize_cdf`) on the CPU, and by the CUDA kernel of
`compression/cdf_rows.py` on a CUDA device, which gives the plain version's
rows bit for bit. So a file encoded on either decodes on the other. The
kernel copies the host's ndtr as scipy computes it with glibc's exp on
x86-64 (FMA build); before its first build in a process `_check_card`
holds it to this host's rows and raises where they differ, so a host that
computes ndtr otherwise cannot use the card's path.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import NamedTuple

import numpy as np
import torch
from scipy.special import ndtr

from contextgs_tpu_torch.compression import cdf_rows, coder
from contextgs_tpu_torch.config import ModelConfig
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.models.context import make_level_predictor
from contextgs_tpu_torch.models.entropy import factorized_pmf_table
from contextgs_tpu_torch.models.levels import (build_level_maps,
                                               find_divide_scale)
from contextgs_tpu_torch.models.mlps import count_mlp_params
from contextgs_tpu_torch.models.quant import (ANCHOR_ROUND_DIGITS,
                                              CLAMP_STEPS, Q_ANCHOR)
from contextgs_tpu_torch.utils import trace
from contextgs_tpu_torch.utils.checkpoint import load_pytree, save_pytree

CHUNK = 1000          # anchors per entropy-coding chunk (ref MAX_batch_size)
# Per-element CDF windows. Each element gets a window of W symbols centred at
# round(μ/Q), its own predicted mean, with W chosen per stream-chunk by a
# cost model (`_choose_window`, min 64, at most MAX_WINDOW, recorded in the
# metadata); the decoder recomputes the window base from the same μ.
# Residuals past the window are not saturated: a window-EDGE symbol is an
# escape code whose true residual follows in a raw side stream (length
# recorded per chunk). Edge bins carry the full gaussian tail mass, so
# escapes are cheap to signal and exact to reconstruct.
MIN_WINDOW = 64
MAX_WINDOW = 2048
MAX_SYMBOL_RANGE = 1 << 16   # guard for the per-channel hyper tables (shared
                             # tables grow with the data range; beyond ±32768
                             # steps the latent has diverged, not drifted)
STREAMS = ("feat", "scaling", "offsets")

log = logging.getLogger("contextgs_tpu_torch")


class DecodedScene(NamedTuple):
    """Compacted decoded arrays (the reference's decoded_version state)."""

    anchor: torch.Tensor     # [N,3] dequantized
    feat: torch.Tensor       # [N,F]
    scaling: torch.Tensor    # [N,6] linear (NOT log)
    offsets: torch.Tensor    # [N,K,3]
    masks: torch.Tensor      # [N,K] {0,1}
    hyper: torch.Tensor      # [N,Fh]
    mlps: object             # models.mlps.DecoderMLPs
    prior: object            # models.entropy.FactorizedPrior | None
    level_scales: list
    voxel_size: float
    level: torch.Tensor | None = None   # [N] int32, set by decode_scene


def _dequantize_anchor_np(codes: np.ndarray, bmin: np.ndarray,
                          bmax: np.ndarray) -> np.ndarray:
    interval = ((bmax - bmin) * Q_ANCHOR + 1e-6).astype(np.float32)
    return (codes.astype(np.float32) * interval + bmin.astype(np.float32))


def _choose_window(abs_res: np.ndarray) -> int:
    """Pick the chunk's window width by total-cost model, not max residual.

    Covering every residual taxes every symbol through the uint16 CDF's
    ≥1-unit bin floor (about −n·log2(1 − (w−1)/2^16) bits) and costs
    n·(w+1) ndtr evaluations to build; an escape costs about 16 payload bits
    plus the edge bin's surprise. Minimizing the modelled total picks small
    windows with a few escapes. The escape count here includes residuals
    of −(w/2 − 1), which `_code_stream` does not escape: the reference counts
    so, and the window it picks is part of the format."""
    n = abs_res.size
    best_w, best_cost = MAX_WINDOW, None
    w = MIN_WINDOW
    while True:
        esc = int((abs_res > (w // 2 - 2)).sum())
        cost = (n * -np.log2(1.0 - (w - 1) / 65536.0)
                + esc * (16.0 + 10.0))   # payload + nominal edge surprise
        if best_cost is None or cost < best_cost:
            best_w, best_cost = w, cost
        if w >= MAX_WINDOW or esc == 0:
            break
        w *= 2
    return best_w


def _window_base(mean: np.ndarray, q: np.ndarray, w: int) -> np.ndarray:
    """Per-element window base symbol = round(μ/Q) − W/2, recomputed
    identically by encoder and decoder (host float64)."""
    return (np.round(mean.astype(np.float64) / q.astype(np.float64))
            .astype(np.int64) - w // 2)


def _windowed_cdf_rows(mean: np.ndarray, scale: np.ndarray, q: np.ndarray,
                       base: np.ndarray, w: int) -> np.ndarray:
    """Float64 CDF rows over each element's own symbol window [base, base+W).

    The first/last bins absorb the full gaussian tail mass (CDF pinned to 0/1
    at the window boundaries): edge symbols double as escape codes, so they
    must stay cheap even when the model puts ~no mass at the window edge."""
    offs = (np.arange(w + 1, dtype=np.float64) - 0.5)[None, :]
    edges = (base[:, None] + offs) * q[:, None].astype(np.float64)
    z = (edges - mean[:, None]) / np.maximum(scale, 1e-9)[:, None]
    # For wide windows, evaluate ndtr only inside ±6σ: beyond it ndtr is 0/1
    # to <1e-9, far below the uint16 quantization grid, and saturated entries
    # dominate wide windows. For narrow windows most entries are live and the
    # boolean gather would cost more than it saves.
    if w > 128:
        c = np.where(z > 0, 1.0, 0.0)
        m = np.abs(z) < 6.0
        c[m] = ndtr(z[m])
    else:
        c = ndtr(z)
    c[:, 0] = 0.0
    c[:, -1] = 1.0
    return np.clip(c, 0.0, 1.0)


def _probe_rows(w: int) -> tuple:
    """(μ, σ, Q, window base) of 256 fixed elements at window w whose rows
    take each branch of the CDF kernel's ndtr: erf's (|z| < √2), erfc's two
    polynomials (|z| < 8√2 and beyond), its underflow (|z| > 37.7) and, for
    w > 128, the cut at |z| = 6. σ runs from 1e-12, under the floor, to
    1e3."""
    i = np.arange(256)
    mean = (0.37 * (i % 7) - 1.1).astype(np.float32)
    scale = np.logspace(-12, 3, i.size).astype(np.float32)
    q = (0.5 + 0.25 * (i % 5)).astype(np.float32)
    return mean, scale, q, _window_base(mean, q, w)


_card_checked = False


def _check_card(device) -> None:
    """Raise unless the CUDA kernel builds this host's plain rows, float64
    and uint16 bit for bit, on the probe rows (`_probe_rows`) at w = 64 and
    256, one of each of its two designs; once a process, before its first
    build for the codec. The kernel copies scipy's ndtr with glibc's exp as
    x86-64's FMA build computes it; on a host whose libm or scipy computes
    otherwise, a file encoded on the card would decode wrongly, with no
    error, on the host."""
    global _card_checked
    if _card_checked:
        return
    for w in (MIN_WINDOW, 4 * MIN_WINDOW):
        mean, scale, q, base = _probe_rows(w)
        got = cdf_rows.cdf_rows(mean, scale, q, base, w, device,
                                float_rows=True)
        fcdf = _windowed_cdf_rows(mean, scale, q, base, w)
        rows = coder.quantize_cdf(fcdf)
        if not (np.array_equal(got[0].view(np.int64), fcdf.view(np.int64))
                and np.array_equal(got[1], rows)):
            raise RuntimeError(
                f"the CDF kernel's rows differ from this host's at w = {w}: "
                "its ndtr copies glibc's exp (x86-64, FMA) and scipy's "
                "Cephes ndtr, which this host does not compute alike")
    _card_checked = True


def _cdf_rows(mean, scale, q, base, w: int, device=None,
              float_rows: bool = False) -> tuple:
    """(float64 rows where `float_rows` asks for them, else None; the uint16
    rows that the encoder and the decoder both code with), built on
    `device`: the kernel on a CUDA device (it launches or raises, after
    `_check_card`), the plain version on the host otherwise."""
    if device is not None and torch.device(device).type == "cuda":
        _check_card(device)
        out = cdf_rows.cdf_rows(mean, scale, q, base, w, device, float_rows)
        trace.count("cdf_card_symbols", mean.shape[0])
        return out
    fcdf = _windowed_cdf_rows(mean, scale, q, base, w)
    return (fcdf if float_rows else None), coder.quantize_cdf(fcdf)


def _code_stream(x, mean, scale, q, stats=None, device=None):
    """Encode one flat stream → (bytes, window, escape bytes, dequantized).

    Symbols are clamped to ±15000·Q (ref encodings.py:203-216); the chunk's
    window width adapts to the residual spread up to MAX_WINDOW. Residuals
    that still fall outside code the nearest window EDGE as an escape and
    append their true relative symbol to a raw side stream, so encode∘decode
    is exactly lossless with no saturation.

    When `stats` (a dict) is passed, accumulates the per-chunk bit-cost
    decomposition used to audit actual-vs-estimate: ideal gaussian
    cross-entropy of the coded symbols, float-windowed-CDF cost,
    quantized-uint16-CDF cost, payload bytes, escape count/bytes. The rows
    are built on `device` (`_cdf_rows`)."""
    if x.size == 0:
        return b"", MIN_WINDOW, b"", x.astype(np.float32)
    x = np.clip(x, -CLAMP_STEPS * q, CLAMP_STEPS * q)
    s = np.round(x.astype(np.float64) / q).astype(np.int64)
    mu_sym = np.round(mean.astype(np.float64)
                      / q.astype(np.float64)).astype(np.int64)
    w = _choose_window(np.abs(s - mu_sym))
    base = _window_base(mean, q, w)
    rel = s - base                                       # true relative symbol
    win = np.clip(rel, 0, w - 1).astype(np.int32)
    # edge symbols always carry an escape payload (even when the true value
    # happens to BE the edge) so the decoder needs no extra signalling
    esc = (win == 0) | (win == w - 1)
    esc_rel = rel[esc]
    # escapes fit int16 in practice (symbols are clamped to ±15000 steps and
    # the window base tracks the predicted mean); pay int32 only when the
    # model mean has diverged that far. Encoded as |w| sign in the metadata:
    # w > 0 → int16 payload, w < 0 → int32 (backward compatible: old streams
    # always stored positive w with int32 payloads via the 3-tuple format).
    use16 = (esc_rel.size == 0
             or (esc_rel.min() >= -32768 and esc_rel.max() < 32768))
    side = esc_rel.astype(np.int16 if use16 else np.int32).tobytes()
    deq = ((base + rel).astype(np.float32) * q.astype(np.float32))
    t0 = time.perf_counter()
    fcdf, rows = _cdf_rows(mean, scale, q, base, w, device,
                           float_rows=stats is not None)
    t1 = time.perf_counter()
    data = coder.encode(rows, win)
    t2 = time.perf_counter()
    if stats is not None:
        stats["cdf_s"] = stats.get("cdf_s", 0.0) + (t1 - t0)
        stats["coder_s"] = stats.get("coder_s", 0.0) + (t2 - t1)
        ar = np.arange(x.size)
        qd = q.astype(np.float64)
        zlo = ((s.astype(np.float64) - 0.5) * qd
               - mean.astype(np.float64)) / np.maximum(scale, 1e-9)
        zhi = zlo + qd / np.maximum(scale, 1e-9)
        p_ideal = np.maximum(ndtr(zhi) - ndtr(zlo), 1e-12)
        p_win = np.maximum(fcdf[ar, win + 1] - fcdf[ar, win], 1e-12)
        wq = np.diff(rows.astype(np.int64) & 0xFFFF, axis=-1)
        wq[:, -1] += 1 << 16     # top value stored mod 2^16
        p_q = wq[ar, win] / 65536.0
        stats["n_sym"] = stats.get("n_sym", 0) + x.size
        stats["ideal_bits"] = (stats.get("ideal_bits", 0.0)
                               - float(np.log2(p_ideal).sum()))
        stats["win_bits"] = (stats.get("win_bits", 0.0)
                             - float(np.log2(p_win).sum()))
        stats["qcdf_bits"] = (stats.get("qcdf_bits", 0.0)
                              - float(np.log2(p_q).sum()))
        stats["payload_bits"] = stats.get("payload_bits", 0) + len(data) * 8
        stats["escape_bits"] = stats.get("escape_bits", 0) + len(side) * 8
        stats["n_escape"] = stats.get("n_escape", 0) + int(esc.sum())
        stats.setdefault("windows", []).append(w)
    return data, w, side, deq


def _decode_stream(data, side, mean, scale, q, w: int, device=None):
    n = mean.shape[0]
    if n == 0:
        return np.zeros(0, np.float32)
    base = _window_base(mean, q, w)
    trace.count("symbols", n)
    with trace.span("codec/cdf"):
        rows = _cdf_rows(mean, scale, q, base, w, device)[1]
    with trace.span("codec/coder"):
        win = coder.decode(rows, data).astype(np.int64)
    rel = win
    esc = (win == 0) | (win == w - 1)
    n_esc = int(esc.sum())
    if n_esc:
        # the payload width is the bytes over the escape count: int16, or
        # int32 where the encoder needed it
        itemsize = len(side) // n_esc
        if itemsize not in (2, 4) or len(side) != n_esc * itemsize:
            raise ValueError(f"escape side stream mismatch: {len(side)}B "
                             f"for {n_esc} escapes")
        rel[esc] = np.frombuffer(side, dtype=f"<i{itemsize}").astype(np.int64)
    elif side:
        raise ValueError("unexpected escape bytes")
    return (base + rel).astype(np.float32) * q.astype(np.float32)


def _ep_host(ep, idx: torch.Tensor) -> dict:
    """EntropyParams gathered at the device rows `idx` → host float32 numpy
    by field name."""
    rows = {name: x.index_select(0, idx) for name, x in ep._asdict().items()}
    with trace.sync("codec.params", len(rows)):
        return {name: x.cpu().numpy() for name, x in rows.items()}


def _chunk_params(eph: dict, sl: slice, cfg: ModelConfig) -> dict:
    """Per stream, the chunk's flat (μ, σ, Q) with Q repeated per column."""
    widths = dict(feat=cfg.feat_dim, scaling=6, offsets=3 * cfg.n_offsets)
    return {name: (eph[f"mean_{name}"][sl].reshape(-1),
                   eph[f"scale_{name}"][sl].reshape(-1),
                   np.repeat(eph[f"q_{name}"][sl], width,
                             axis=1).reshape(-1))
            for name, width in widths.items()}


def _hyper_rows(prior, h_lo: int, h_hi: int) -> np.ndarray:
    """Per channel, the uint16 CDF row of the prior over [h_lo, h_hi]."""
    pmf = factorized_pmf_table(prior, h_lo, h_hi).cpu().numpy().astype(
        np.float64)                                  # [C,S]
    cdf = np.concatenate([np.zeros((pmf.shape[0], 1)),
                          np.cumsum(pmf, axis=1)], axis=1)
    cdf /= np.maximum(cdf[:, -1:], 1e-12)
    return coder.quantize_cdf(np.clip(cdf, 0, 1))


def _mask_row(p1: float) -> np.ndarray:
    return coder.quantize_cdf(np.array([0.0, 1 - p1, 1.0]))


def _context(anchor_np: np.ndarray, hyper_np: np.ndarray, disable_hyper,
             level_scales, voxel_size: float, cfg: ModelConfig, dev):
    """The coding context both sides build from the decoded anchors and
    hyper latents: (level maps, anchor_q, hyper_ctx, feat_state,
    scaling_state), the last two zero until their levels are coded."""
    n = anchor_np.shape[0]
    anchor_q = torch.from_numpy(anchor_np).to(dev)
    maps = build_level_maps(anchor_q, torch.ones(n, dtype=torch.bool,
                                                 device=dev),
                            voxel_size, tuple(level_scales), cfg.level_num)
    hyper_ctx = torch.from_numpy(
        hyper_np * (0.0 if disable_hyper else 1.0)).to(dev)
    return (maps, anchor_q, hyper_ctx,
            torch.zeros((n, cfg.feat_dim), dtype=torch.float32, device=dev),
            torch.zeros((n, 6), dtype=torch.float32, device=dev))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def encode_scene(params: st.Params, buffers: st.Buffers, cfg: ModelConfig,
                 level_scales, voxel_size: float, out_dir: str,
                 disable_hyper: bool = False, return_states: bool = False,
                 stream_stats: dict | None = None):
    """conduct_encoding equivalent. Returns a size breakdown in bits (plus
    the encoder-side dequantized states as numpy when return_states, for
    the round-trip checks). `level_scales` are searched over the kept
    anchors first when training never reached the context phase."""
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    dev = params.anchor.device

    keep = st.get_mask_anchor(params, buffers.alive)
    idx_keep = torch.nonzero(keep).squeeze(1)
    n = int(idx_keep.numel())

    def kept(x):
        return _host(x.index_select(0, idx_keep))

    bmin = _host(buffers.bound_min)
    bmax = _host(buffers.bound_max)
    anchors_raw = kept(params.anchor)

    if level_scales is None or len(level_scales) < cfg.level_num - 1:
        # as the reference, search the scales on first use (ref
        # gaussian_model.py:1042)
        level_scales = find_divide_scale(anchors_raw, voxel_size, bmin, bmax,
                                         cfg.target_ratio, cfg.level_num)
    level_scales = [float(s) for s in level_scales]

    # --- anchors: 16-bit codes, stored raw (ref :1097-1101) ---
    interval = (bmax - bmin) * Q_ANCHOR + 1e-6
    codes = np.clip(np.floor((anchors_raw - bmin) / interval), 0,
                    2 ** ANCHOR_ROUND_DIGITS - 1).astype(np.uint16)
    np.save(os.path.join(out_dir, "anchor.npy"), codes)
    anchor_q_np = _dequantize_anchor_np(codes, bmin, bmax)

    # --- hyper latent: factorized prior, per-channel streams (ref :1082-1109) ---
    hyper = kept(params.hyper_latent)
    hyper_sym = np.clip(np.round(hyper), -(MAX_SYMBOL_RANGE // 2),
                        MAX_SYMBOL_RANGE // 2).astype(np.int32)
    if disable_hyper:
        hyper_sym = np.zeros_like(hyper_sym)
    h_lo = int(hyper_sym.min()) - 1 if n else 0
    h_hi = int(hyper_sym.max()) + 1 if n else 0
    hyper_rows = _hyper_rows(params.prior, h_lo, h_hi)
    hyper_streams = [coder.encode_shared(hyper_rows[c], hyper_sym[:, c] - h_lo)
                     for c in range(hyper.shape[1])]
    with open(os.path.join(out_dir, "hyper.b"), "wb") as f:
        f.write(b"".join(hyper_streams))
    hyper_deq = hyper_sym.astype(np.float32)

    # --- masks: Bernoulli stream (ref :1265-1269) ---
    masks = kept(st.get_mask(params))                          # [N,K]
    mask_bits = masks.reshape(-1).astype(np.int32)
    p1 = float(np.clip(mask_bits.mean() if mask_bits.size else 0.5,
                       1e-6, 1 - 1e-6))
    mask_stream = coder.encode_shared(_mask_row(p1), mask_bits)
    with open(os.path.join(out_dir, "masks.b"), "wb") as f:
        f.write(mask_stream)

    # --- levels on the decoded anchors, coarsest first ---
    maps, anchor_q, hyper_ctx, feat_state, scaling_state = _context(
        anchor_q_np, hyper_deq, disable_hyper, level_scales, voxel_size, cfg,
        dev)
    level = _host(maps.level)
    predictor = make_level_predictor(cfg)
    values = dict(feat=kept(params.anchor_feat),
                  scaling=np.exp(kept(params.scaling_log)),
                  offsets=kept(params.offsets).reshape(n, -1))

    meta_levels = []
    bits = dict(anchor=n * 3 * 16,
                hyper=sum(len(s) for s in hyper_streams) * 8,
                masks=len(mask_stream) * 8, feat=0, scaling=0, offsets=0)
    offsets_q_np = np.zeros_like(values["offsets"])
    sst = (None if stream_stats is None else
           {k: stream_stats.setdefault(k, {}) for k in STREAMS})

    for li in reversed(range(cfg.level_num)):
        idx = np.where(level == li)[0]
        idx_t = torch.from_numpy(idx).to(dev)
        eph = _ep_host(predictor(params.mlps, li, anchor_q, feat_state,
                                 scaling_state, maps.parent, hyper_ctx),
                       idx_t)
        chunks = []
        streams = {name: [] for name in STREAMS}
        feat_deq_level = np.zeros((len(idx), cfg.feat_dim), np.float32)
        scaling_deq_level = np.zeros((len(idx), 6), np.float32)
        for s0 in range(0, len(idx), CHUNK):
            sl = slice(s0, min(s0 + CHUNK, len(idx)))
            rows = idx[sl]
            nn = len(rows)
            cp = _chunk_params(eph, sl, cfg)
            m3 = np.repeat(masks[rows], 3, axis=1).reshape(-1).astype(bool)
            coded = {}
            for name in STREAMS:
                x = values[name][rows].reshape(-1)
                mean, scale, q = cp[name]
                if name == "offsets":
                    x, mean, scale, q = x[m3], mean[m3], scale[m3], q[m3]
                coded[name] = _code_stream(
                    x, mean, scale, q,
                    stats=None if sst is None else sst[name], device=dev)
                # chunk layout in the stream file: [range-coded bytes]
                # [escape payload]
                streams[name].append(coded[name][0] + coded[name][2])
            chunks.append(dict(n=nn, **{name: (len(coded[name][0]),
                                               coded[name][1],
                                               len(coded[name][2]))
                                        for name in STREAMS}))
            feat_deq_level[sl] = coded["feat"][3].reshape(nn, cfg.feat_dim)
            scaling_deq_level[sl] = coded["scaling"][3].reshape(nn, 6)
            off_full = np.zeros(nn * 3 * cfg.n_offsets, np.float32)
            off_full[m3] = coded["offsets"][3]
            offsets_q_np[rows] = off_full.reshape(nn, -1)
        for name in STREAMS:
            with open(os.path.join(out_dir, f"{name}{li}.b"), "wb") as f:
                f.write(b"".join(streams[name]))
            bits[name] += sum(len(b) for b in streams[name]) * 8
        meta_levels.append(dict(level=li, count=len(idx), chunks=chunks))
        feat_state.index_copy_(0, idx_t,
                               torch.from_numpy(feat_deq_level).to(dev))
        scaling_state.index_copy_(0, idx_t,
                                  torch.from_numpy(scaling_deq_level).to(dev))

    n_prior = sum(x.numel() for field in params.prior for x in field)
    mlp_bits = (count_mlp_params(params.mlps) + n_prior) * 32
    meta = dict(n=n, chunk=CHUNK, levels=meta_levels,
                hyper_range=(h_lo, h_hi),
                hyper_lens=[len(s) for s in hyper_streams],
                prob_masks=p1, bound_min=bmin, bound_max=bmax,
                level_scales=level_scales, voxel_size=float(voxel_size),
                disable_hyper=bool(disable_hyper))
    with open(os.path.join(out_dir, "meta.pkl"), "wb") as f:
        pickle.dump(meta, f)
    save_pytree(os.path.join(out_dir, "mlp.pkl"), params.mlps, params.prior)
    bits["meta"] = os.path.getsize(os.path.join(out_dir, "meta.pkl")) * 8
    bits["mlp"] = mlp_bits
    bits["total"] = sum(bits.values())
    bits["time_s"] = time.time() - t0
    if return_states:
        states = dict(anchor=anchor_q_np, feat=_host(feat_state),
                      scaling=_host(scaling_state),
                      offsets=offsets_q_np.reshape(n, cfg.n_offsets, 3),
                      masks=masks, hyper=hyper_deq, level=level)
        return bits, states
    return bits


@torch.no_grad()
def decode_scene(out_dir: str, cfg: ModelConfig, device=None) -> DecodedScene:
    """conduct_decoding equivalent: files → compacted decoded tensors on
    `device` (default: the CUDA card). Raises where a stream is not
    consumed in full or a level's anchor count differs from the encoder's."""
    dev = resolve_device(device)
    with trace.span("codec/decode_scene"):
        return _decode_scene(out_dir, cfg, dev)


def _decode_scene(out_dir: str, cfg: ModelConfig, dev) -> DecodedScene:
    t0 = time.time()
    with trace.span("codec/load"):
        with open(os.path.join(out_dir, "meta.pkl"), "rb") as f:
            meta = pickle.load(f)
        n = meta["n"]
        mlps, prior = load_pytree(os.path.join(out_dir, "mlp.pkl"), cfg, dev)
        codes = np.load(os.path.join(out_dir, "anchor.npy"))
        anchor_np = _dequantize_anchor_np(codes, meta["bound_min"],
                                          meta["bound_max"])

    with trace.span("codec/hyper"):
        h_lo, h_hi = meta["hyper_range"]
        hyper_rows = _hyper_rows(prior, h_lo, h_hi)
        with open(os.path.join(out_dir, "hyper.b"), "rb") as f:
            hyper_all = f.read()
        hyper_sym = np.zeros((n, cfg.hyper_dim), np.int32)
        pos = 0
        for c, ln in enumerate(meta["hyper_lens"]):
            hyper_sym[:, c] = coder.decode_shared(
                hyper_rows[c], n, hyper_all[pos:pos + ln]) + h_lo
            pos += ln
        if pos != len(hyper_all):
            raise ValueError("hyper stream not fully consumed")
        hyper = hyper_sym.astype(np.float32)

    with trace.span("codec/masks"):
        with open(os.path.join(out_dir, "masks.b"), "rb") as f:
            masks = coder.decode_shared(_mask_row(meta["prob_masks"]),
                                        n * cfg.n_offsets, f.read())
        masks = masks.reshape(n, cfg.n_offsets).astype(np.float32)

    # levels on the decoded anchors: the encoder's computation
    with trace.span("codec/context"):
        maps, anchor_q, hyper_ctx, feat_state, scaling_state = _context(
            anchor_np, hyper, meta["disable_hyper"], meta["level_scales"],
            meta["voxel_size"], cfg, dev)
        with trace.sync("codec.level"):
            level = _host(maps.level)
    predictor = make_level_predictor(cfg)
    out = dict(feat=np.zeros((n, cfg.feat_dim), np.float32),
               scaling=np.zeros((n, 6), np.float32),
               offsets=np.zeros((n, 3 * cfg.n_offsets), np.float32))

    for entry in sorted(meta["levels"], key=lambda e: -e["level"]):
        li = entry["level"]
        idx = np.where(level == li)[0]
        if len(idx) != entry["count"]:
            raise ValueError(f"level {li}: {len(idx)} anchors against the "
                             f"encoder's {entry['count']}")
        with trace.span("codec/predict"):
            idx_t = torch.from_numpy(idx).to(dev)
            eph = _ep_host(predictor(mlps, li, anchor_q, feat_state,
                                     scaling_state, maps.parent, hyper_ctx),
                           idx_t)
        data, pos = {}, {}
        for name in STREAMS:
            with open(os.path.join(out_dir, f"{name}{li}.b"), "rb") as f:
                data[name] = f.read()
            pos[name] = 0
        for ci, ch in enumerate(entry["chunks"]):
            s0 = ci * meta["chunk"]
            sl = slice(s0, s0 + ch["n"])
            rows = idx[sl]
            cp = _chunk_params(eph, sl, cfg)
            m3 = np.repeat(masks[rows], 3, axis=1).reshape(-1).astype(bool)
            for name in STREAMS:
                ln, w, ls = ch[name]
                p = pos[name]
                pos[name] = p + ln + ls
                blob = data[name]
                mean, scale, q = cp[name]
                if name == "offsets":
                    mean, scale, q = mean[m3], scale[m3], q[m3]
                vals = _decode_stream(blob[p:p + ln], blob[p + ln:p + ln + ls],
                                      mean, scale, q, w, dev)
                if name == "offsets":
                    full = np.zeros(ch["n"] * 3 * cfg.n_offsets, np.float32)
                    full[m3] = vals
                    vals = full
                out[name][rows] = vals.reshape(ch["n"], -1)
        for name in STREAMS:
            if pos[name] != len(data[name]):
                raise ValueError(f"{name}{li} stream not fully consumed")
        feat_state.index_copy_(0, idx_t,
                               torch.from_numpy(out["feat"][idx]).to(dev))
        scaling_state.index_copy_(
            0, idx_t, torch.from_numpy(out["scaling"][idx]).to(dev))

    log.info("decoded %d anchors in %.1fs", n, time.time() - t0)

    def put(x):
        return torch.from_numpy(x).to(dev)

    # every anchor lies in one level, so the states hold every decoded row
    return DecodedScene(
        anchor=put(anchor_np), feat=feat_state, scaling=scaling_state,
        offsets=put(out["offsets"].reshape(n, cfg.n_offsets, 3)),
        masks=put(masks), hyper=put(hyper), mlps=mlps, prior=prior,
        level_scales=list(meta["level_scales"]),
        voxel_size=meta["voxel_size"], level=maps.level)
