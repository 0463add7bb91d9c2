"""Decode-only driver (port of the JAX package's root `decompress.py`):
bitstreams → decode → render the test split → metrics, written as
"decoded" into `<model_path>/results.json`.

    python -m contextgs_tpu_torch.drivers.decompress -s <scene_dir> \
        -m <model_path> [--save_images] [--force_cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from contextgs_tpu_torch import drivers
from contextgs_tpu_torch import evaluation as ev
from contextgs_tpu_torch.compression.codec import decode_scene


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--save_images", action="store_true")
    drivers.add_common(p)
    args = p.parse_args(argv)
    dev = drivers.check_common(p, args)

    with drivers.logging_to() as log:
        cfg = drivers.read_config(args.model_path)
        scene = drivers.scene_of(cfg, args.source_path)
        dec = decode_scene(os.path.join(args.model_path, "bitstreams"),
                           cfg.model, device=dev)
        log.info("decoded %d anchors", dec.anchor.shape[0])

        cam0 = scene.test_cameras[0]
        renderer = ev.make_decoded_renderer(dec, cfg, cam0.width,
                                            cam0.height, device=dev)
        renders, gts, fps = ev.render_set(
            renderer, scene.test_cameras, drivers.background(cfg),
            out_dir=os.path.join(args.model_path, "decoded_test"),
            save_images=args.save_images)
        metrics = ev.evaluate_images(renders, gts, device=dev)
        log.info("decoded test: PSNR %.3f SSIM %.4f FPS %.1f",
                 metrics["PSNR"], metrics["SSIM"], fps)
        ev.write_results(args.model_path, "decoded", metrics, None, fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
