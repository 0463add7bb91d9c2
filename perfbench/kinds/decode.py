"""Decoding cells: `compression.codec.decode_scene` called again and again on
one bitstream, which set-up encodes with `compression.codec.encode_scene`
from the harness's seeded scene state into a directory under `TMPDIR`.

Set-up draws the state, encodes it and decodes it once. The window then
decodes whole scenes until `--seconds` have passed: it ends at a decode's
end. Every decode of the window is compared with the reference's own
quantization of the state it was handed (`reference/codec.py`): every
anchor code, hyper symbol and mask has to come back, and every other value
has to be a whole number of the reference's predicted Q within half a Q
of the value coded.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from perfbench import inputs, program
from perfbench.harness import Window, plant
from perfbench.reference.codec import gaps, quantize

CODEC = "contextgs_tpu_torch.compression.codec"
CODER = "contextgs_tpu_torch.compression.coder"
CONTEXT = "contextgs_tpu_torch.models.context"


def _altered(fn):
    """The first anchor's first decoded feature five off and its position
    one grid step off, where the decode hands them over (earlier, the
    autoregressive chain would derail)."""
    def call(*args, **kw):
        dec = fn(*args, **kw)
        feat, anchor = dec.feat.clone(), dec.anchor.clone()
        feat[0, 0] += 5.0
        anchor[0, 0] += 1e-3
        return dec._replace(feat=feat, anchor=anchor)
    return call


FAULTS = {"altered_answer": [(CODEC, "decode_scene", _altered)]}


def _host(dec) -> dict:
    """A `DecodedScene` as numpy arrays by the reference's names."""
    return dict(anchor=dec.anchor.cpu().numpy(),
                hyper=dec.hyper.cpu().numpy().astype(np.int64),
                masks=dec.masks.cpu().numpy(),
                feat=dec.feat.cpu().numpy(), scaling=dec.scaling.cpu().numpy(),
                offsets=dec.offsets.reshape(dec.offsets.shape[0], -1)
                .cpu().numpy())


class Job:
    NAME_SPANS = {
        "cdf": (CODEC, "_cdf_rows"), "coder": (CODER, "decode"),
        "coder_shared": (CODER, "decode_shared"),
        "levels": (CODEC, "build_level_maps"),
        "predict": (CONTEXT, "predict_entropy_params"),
        "load": (CODEC, "load_pytree"),
    }

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.mcfg = inputs.model_config(config)
        self.faults: list = []
        self.decoded: list = []

    def _inputs(self):
        if not hasattr(self, "state"):
            self.state = inputs.anchor_state(self.config, self.seed,
                                             self.device)
            self.nets = inputs.net_weights(self.config)
            self.scales = inputs.level_scales(self.state, self.config)
            if "coded" in self.config:
                inputs.coded_state(self.state, self.nets, self.config,
                                   self.scales, self.seed, self.device)

    def run(self, seconds: float, tracer=None) -> Window:
        from contextgs_tpu_torch.compression import codec

        self._inputs()
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (
            lambda: None)
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.ExitStack() as stack:
            out_dir = os.path.join(tmp, "bitstreams")
            mcfg = program.model_config(self.config)
            params, buffers = program.params(self.state, self.nets,
                                             self.config, self.device)
            codec.encode_scene(params, buffers, mcfg, self.scales,
                         mcfg.voxel_size, out_dir)
            del params, buffers
            plant(stack, FAULTS, self.faults)
            for _ in range(self.traffic["warmup_decodes"]):
                codec.decode_scene(out_dir, mcfg, self.device)
            sync()
            if tracer is not None:
                tracer.start()
            start = time.perf_counter()
            units, lat = 0, []
            while True:
                t0 = time.perf_counter()
                dec = codec.decode_scene(out_dir, mcfg, self.device)
                lat.append(time.perf_counter() - t0)
                units += 1
                self.decoded.append(dec)
                if tracer is not None:
                    tracer.unit()
                    if units >= self.traffic["trace_units"]:
                        tracer.stop()
                        end = tracer.t1
                        break
                elif time.perf_counter() - start >= seconds:
                    sync()
                    end = time.perf_counter()
                    break
        self.decoded = [_host(d) for d in self.decoded]
        return Window(start=start, end=end, units=units, latencies=lat,
                      attempted=units)

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self, control: bool = False) -> dict:
        """{number: (value, limit)}: the worst decode of the window (with
        `control`, the reference's quantization in TF32) against the
        reference's quantization (`reference.codec.gaps`)."""
        self._inputs()
        ref = quantize(self.state, self.nets, self.mcfg, self.scales,
                       self.device)
        if control:
            tf = quantize(self.state, self.nets, self.mcfg, self.scales,
                          self.device, tf32=True)
            got = [dict(anchor=tf["anchor"], hyper=tf["hyper"],
                        masks=tf["masks"],
                        **{s: tf[f"{s}_sym"].astype(np.float32)
                           * tf[f"{s}_q"]
                           for s in ("feat", "scaling", "offsets")})]
        else:
            got = self.decoded
        # no decode at all is no answer, and wrong
        read = [gaps(d, ref) for d in got] or [(float("inf"),
                                                 float("inf"))]
        limits = self.traffic["limits"]
        return {"codes_off": (max(r[0] for r in read), limits["codes_off"]),
                "symbol_gap": (max(r[1] for r in read),
                               limits["symbol_gap"])}
