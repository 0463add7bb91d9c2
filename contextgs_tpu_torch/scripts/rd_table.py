"""Aggregate an RD-sweep output directory into a markdown table (port of
the root `scripts/rd_table.py`).

Reads <out>/summary.jsonl plus each run's results.json / outputs.log and
prints the rate-distortion table: λ, iterations completed, decoded
PSNR/SSIM, actual bitstream MB, model-estimated MB (the estimate-vs-actual
gap validates the rate model), encode/decode seconds and training seconds.
Later summary entries win over earlier ones of the same λ; a malformed
entry (no λ) is skipped. Runs are read from `<out>/l{λ:g}/`, the layout of
the JAX package's `scripts/r3_suite.py` (not the
`<out>/<dataset>/<scene>/lmbda_<λ>/` that `sweep` writes).

    python -m contextgs_tpu_torch.scripts.rd_table --out <dir>
"""

import argparse
import json
import os
import re
import sys


def parse_log(path):
    """Pull encode/decode timings + final size estimate from outputs.log."""
    info = {}
    if not os.path.exists(path):
        return info
    txt = open(path, errors="replace").read()
    m = re.findall(r"encoded .* in ([0-9.]+)s", txt)
    if m:
        info["encode_s"] = float(m[-1])
    m = re.findall(r"decoded .* in ([0-9.]+)s", txt)
    if m:
        info["decode_s"] = float(m[-1])
    m = re.findall(r"size estimate: .*'total': ([0-9.]+)", txt)
    if m:
        info["estimate_MB"] = float(m[-1])
    m = re.findall(r"training done in ([0-9.]+)s", txt)
    if m:
        info["train_s"] = float(m[-1])
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args(argv)

    rows = []
    seen = set()
    summ = os.path.join(args.out, "summary.jsonl")
    entries = []
    if os.path.exists(summ):
        with open(summ) as f:
            entries = [json.loads(x) for x in f if x.strip()]
    # later entries win: a relaunched run's completion supersedes an earlier
    # killed attempt's partial entry
    for e in reversed(entries):
        lm = e.get("lmbda")
        if lm is None:   # malformed/hand-written entry: skip, don't crash
            continue
        key = f"l{lm:g}"
        if key in seen:
            continue
        seen.add(key)
        run_dir = os.path.join(args.out, key)
        res = e.get("results")
        if res is None and os.path.exists(os.path.join(run_dir,
                                                       "results.json")):
            res = json.load(open(os.path.join(run_dir, "results.json")))
        log = parse_log(os.path.join(run_dir, "outputs.log"))
        prog = e.get("last_progress", {})
        it_done = (e["iters"] if res else prog.get("iteration", "?"))
        row = dict(lmbda=lm, iters=it_done, rc=e.get("rc"))
        if res:
            # results.json is {name: {...}} keyed by split name; prefer the
            # round-5 re-encode entry (test.py writes "ours_from_ckpt") over
            # the in-training "ours" so the table reflects the current codec
            if all(isinstance(v, dict) for v in res.values()):
                first = res.get("ours_from_ckpt") or next(iter(res.values()))
            else:
                first = res
            row.update(PSNR=first.get("PSNR"), SSIM=first.get("SSIM"),
                       size_MB=first.get("size_MB"), FPS=first.get("FPS"))
        row.update(log)
        rows.append(row)

    rows.sort(key=lambda r: -(r["lmbda"] or 0))
    cols = ["lmbda", "iters", "PSNR", "SSIM", "size_MB", "estimate_MB",
            "encode_s", "decode_s", "train_s", "rc"]
    print("| " + " | ".join(cols) + " |")
    print("|" + "---|" * len(cols))
    for r in rows:
        def fmt(c, v):
            if c == "lmbda" and isinstance(v, float):
                return f"{v:g}"    # 0.0005 must not display as "0.001"
            if isinstance(v, float):
                return f"{v:.3f}"
            return str(v) if v is not None else "—"
        print("| " + " | ".join(fmt(c, r.get(c)) for c in cols) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
