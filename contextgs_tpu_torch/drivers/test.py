"""Evaluation driver (port of the JAX package's root `test.py`): load a
training checkpoint, then encode → decode → render → metrics, written as
"ours_from_ckpt" into `<model_path>/results.json`.

    python -m contextgs_tpu_torch.drivers.test -s <scene_dir> \
        -m <model_path> [--checkpoint <file>] [--save_images] [--force_cpu]

Unlike the decompress driver this starts from the trained state, not the
bitstream. The checkpoint is the newest `chkpnt{it}` of the model
directory in either package's format: the port's `chkpnt{it}.pt` or the
JAX package's `chkpnt{it}.pkl` (read without JAX). A JAX model directory
(its `cfg_args` and a JAX checkpoint) reads the same way.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

from contextgs_tpu_torch import drivers
from contextgs_tpu_torch import evaluation as ev
from contextgs_tpu_torch.compression.codec import decode_scene, encode_scene
from contextgs_tpu_torch.models import state as st
from contextgs_tpu_torch.utils.checkpoint import load_checkpoint

CHECKPOINT = re.compile(r"chkpnt(\d+)\.(pt|pkl)$")


def newest_checkpoint(model_path: str):
    """The `chkpnt{it}.pt` or `chkpnt{it}.pkl` of the highest iteration in
    `model_path`, or None."""
    found = [(int(m.group(1)), path)
             for path in glob.glob(os.path.join(model_path, "chkpnt*"))
             if (m := CHECKPOINT.search(os.path.basename(path)))]
    return max(found)[1] if found else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--save_images", action="store_true")
    drivers.add_common(p)
    args = p.parse_args(argv)
    dev = drivers.check_common(p, args)

    with drivers.logging_to() as log:
        cfg = drivers.read_config(args.model_path)
        ckpt_path = args.checkpoint or newest_checkpoint(args.model_path)
        if ckpt_path is None:
            log.error("no checkpoint in %s", args.model_path)
            return 1
        log.info("loading %s", ckpt_path)
        scene = drivers.scene_of(cfg, args.source_path)
        params, buffers, _, meta = load_checkpoint(
            ckpt_path, st.blank_params(cfg.model, device=dev), dev)

        out_dir = os.path.join(args.model_path, "bitstreams")
        bits = encode_scene(params, buffers, cfg.model, meta["level_scales"],
                            meta["voxel_size"], out_dir,
                            disable_hyper=cfg.opt.disable_hyper)
        log.info("encoded %.3f MB", bits["total"] / 8 / 1024 / 1024)
        dec = decode_scene(out_dir, cfg.model, device=dev)

        cam0 = scene.test_cameras[0]
        renderer = ev.make_decoded_renderer(dec, cfg, cam0.width,
                                            cam0.height, device=dev)
        renders, gts, fps = ev.render_set(
            renderer, scene.test_cameras, drivers.background(cfg),
            out_dir=os.path.join(args.model_path, "test"),
            save_images=args.save_images)
        metrics = ev.evaluate_images(renders, gts, device=dev)
        log.info("test: PSNR %.3f SSIM %.4f FPS %.1f", metrics["PSNR"],
                 metrics["SSIM"], fps)
        ev.write_results(args.model_path, "ours_from_ckpt", metrics, bits,
                         fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
