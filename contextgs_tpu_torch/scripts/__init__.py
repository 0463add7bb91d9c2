"""The port's counterparts of the root `scripts/`, run as
`python -m contextgs_tpu_torch.scripts.<name>`:

- the kernel labs `kvariants` (K4, the tile-blend forward in stages) and
  `xpose_lab` (K5 and K6, the slab transposes, and the layout rows around
  them);
- `make_synth_scene`, the synthetic COLMAP scene rendered through K1;
- the sharded path's harnesses `scaling_bench` (pixels/s of the sharded
  context step per world size, K1 and K2 banded) and `growth_parity` (one
  densify on identical state, single process against N ranks);
- the codec's audit `codec_diag` (bits per stream: ideal, window,
  quantized CDF, payload, escape);
- the rate-distortion tools `sweep` (λ runs of `drivers.train`),
  `rd_table` and `collect_results`.

Each runs on the card unless asked for the CPU (`device="cpu"`, or
`--force_cpu` on the command line).
"""

from __future__ import annotations

import time

import torch

ITERS = 20      # back-to-back calls a timing averages, the labs' `iters`


def time_ms(fn, device: torch.device, iters: int = ITERS) -> float:
    """Mean time of `fn()` over `iters` back-to-back calls after one warm-up
    call: by CUDA events on a CUDA device (the card's time, the host's
    launch gaps included), by the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
