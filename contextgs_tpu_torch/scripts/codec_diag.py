"""Audit the entropy coder: actual bytes against the model's estimate, per
stream (port of the root `scripts/codec_diag.py`).

Loads the newest training checkpoint of a model directory (the port's
`chkpnt{it}.pt`, or the JAX package's `chkpnt{it}.pkl` with its
`.meta.pkl`, as `drivers.test` reads either), runs `encode_scene` with
`stream_stats` into a temporary directory, and prints the bit cost per
stream:

  ideal    — gaussian cross-entropy of the ACTUAL coded symbols under the
             coder's own (mu, sigma, Q): the best any coder could do given
             this entropy model
  window   — cost under the float windowed CDF (adds window-edge/escape
             probability reshaping)
  qcdf     — cost under the uint16-quantized CDF (adds the >=1-bin floor:
             the mass stolen from real bins scales with the window width)
  payload  — bytes the range coder actually wrote (adds coder slack, ~0)
  escape   — raw side-stream bytes for out-of-window residuals

    python -m contextgs_tpu_torch.scripts.codec_diag -m <model_path> \\
        [--checkpoint <file>] [--out <json>] [--force_cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from contextgs_tpu_torch import drivers
from contextgs_tpu_torch.compression.codec import encode_scene
from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.drivers.test import newest_checkpoint
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.utils.checkpoint import load_checkpoint

MB = 8 * 1024 * 1024


def audit(model_path: str, checkpoint: str | None = None,
          device=None) -> tuple[dict, dict]:
    """(stream statistics by stream, the encode's size breakdown in bits)
    of the model directory's newest checkpoint, or of `checkpoint`."""
    dev = resolve_device(device)
    cfg = drivers.read_config(model_path)
    ckpt_path = checkpoint or newest_checkpoint(model_path)
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoint in {model_path}")
    params, buffers, _, meta = load_checkpoint(
        ckpt_path, st.blank_params(cfg.model, device=dev), dev)
    stats: dict = {}
    with tempfile.TemporaryDirectory() as td:
        bits = encode_scene(params, buffers, cfg.model, meta["level_scales"],
                            meta["voxel_size"], td,
                            disable_hyper=cfg.opt.disable_hyper,
                            stream_stats=stats)
    return stats, bits


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--force_cpu", action="store_true")
    p.add_argument("--out", default=None,
                   help="also dump the decomposition as JSON here")
    args = p.parse_args(argv)
    stats, bits = audit(args.model_path, args.checkpoint,
                        "cpu" if args.force_cpu else None)

    print(f"{'stream':>8} {'n_sym':>9} {'ideal':>8} {'window':>8} "
          f"{'qcdf':>8} {'payload':>8} {'escape':>8} {'act/ideal':>9} "
          f"{'esc%':>6} windows")
    report = {}
    for name, s in stats.items():
        if not s:
            continue
        act = s["payload_bits"] + s["escape_bits"]
        wins = sorted(set(s.get("windows", [])))
        print(f"{name:>8} {s['n_sym']:>9} {s['ideal_bits']/MB:>8.4f} "
              f"{s['win_bits']/MB:>8.4f} {s['qcdf_bits']/MB:>8.4f} "
              f"{s['payload_bits']/MB:>8.4f} {s['escape_bits']/MB:>8.4f} "
              f"{act/max(s['ideal_bits'],1e-9):>9.3f} "
              f"{100*s['n_escape']/max(s['n_sym'],1):>6.2f} {wins}")
        report[name] = {k: (v if not isinstance(v, float) else round(v, 1))
                        for k, v in s.items()}
    print("encode totals (MB):",
          {k: round(v / MB, 4) for k, v in bits.items()
           if k not in ("time_s",)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(streams=report,
                           totals={k: v for k, v in bits.items()}), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
