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
  `r3_suite` (one synthetic scene, a run a λ into `<out>/l{λ:g}/` and
  `<out>/summary.jsonl`), `rd_table` (which reads that layout) and
  `collect_results`;
- the rate-distortion queue, the same layout: `rd_queue` (each further λ
  branched from one run's checkpoint at the context transition),
  `rd_finalize` (the test driver, `codec_diag`, `rd_table` and the bench
  over every point) and `chip_session` (wait for the card, run the
  measurement scripts, start the queue);
- the glue labs `r3_micro` (transposes, row gathers, cumsums, sorts and
  scatters at fixed synthetic shapes) and `pack_lab` (the bench frame's
  row gathers and the per-gaussian regroup of per-instance gradients);
- the scripts that measure the rasterizer: `profile` (the bench frame's
  forward+backward end to end, then stage by stage by CUDA events and by
  the profiler's kernel time), `thr_sweep` (forward+backward Mpix/s from
  200k gaussians at 1280x720 to 2M at 1280x720 and 1M at 1920x1080),
  `fps_bench` (a decoded scene's views one by one against chained),
  `kern_micro` (K1 and K2 per tile against per instance on the lab's
  table) and `corner_diag` (tile instances whose alpha never reaches 1/255
  in their tile).

Each runs on the card unless asked for the CPU (`device="cpu"`, or
`--force_cpu` on the command line), for example at a small size:

    python -m contextgs_tpu_torch.scripts.profile --gauss 2000 --width 96 \
        --height 64 --iters 2 --force_cpu
    python -m contextgs_tpu_torch.scripts.thr_sweep --iters 1 \
        --configs 2000x96x64,2000x128x96 --force_cpu
    python -m contextgs_tpu_torch.scripts.fps_bench --anchors 300 --views 3 \
        --width 64 --height 48 --force_cpu
    python -m contextgs_tpu_torch.scripts.corner_diag --n_gauss 3000 \
        --width 128 --height 96 --force_cpu
    python -m contextgs_tpu_torch.scripts.kern_micro --tiles 8x4 --iters 1 \
        --force_cpu
    python -m contextgs_tpu_torch.scripts.r3_suite --out <dir> --res 64 \
        --cams 8 --gauss 2000 --points 300 --iters 30 --lmbdas 0.004 \
        --force_cpu
    python -m contextgs_tpu_torch.scripts.rd_queue --out <dir> \
        --base <dir>/l0.004/chkpnt20.pt --lmbdas 0.002 --iters 30 \
        --checkpoint_iterations 25 --no_wait --extra_flags '<schedule>' \
        --force_cpu
    python -m contextgs_tpu_torch.scripts.rd_finalize --out <dir> --force_cpu
    python -m contextgs_tpu_torch.scripts.chip_session --out <dir> --dry_run
    python -m contextgs_tpu_torch.scripts.r3_micro --iters 2 --force_cpu
    python -m contextgs_tpu_torch.scripts.pack_lab --iters 2 --force_cpu

Without size flags they run at the JAX scripts' sizes on the card. The JAX
scripts' TPU knobs (`--budget`, `--chunk`, `--budget_per_mpix`) are
refused with the reason (`drivers.Refused`). Never put this directory on
`sys.path`: `profile` would shadow the standard library's module.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

import torch

ITERS = 20      # back-to-back calls a timing averages, the labs' `iters`
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMED_OUT = 124      # the exit code of coreutils' `timeout` when it fires


def run_logged(cmd: list, log_path: str, timeout: float | None = None) -> int:
    """Run `cmd` from the repository's root, its output appended to
    `log_path`, in a process group of its own; → its exit code, or
    `TIMED_OUT` where it ran past `timeout` seconds. On a timeout, or when
    this process is interrupted (SIGINT, or a SIGTERM while the child runs,
    which is raised here as a KeyboardInterrupt when this is the main
    thread), the whole group is terminated (killed after 10 s), so that no
    child outlives the call."""
    print(f"+ {' '.join(cmd)}", flush=True)
    on_main = threading.current_thread() is threading.main_thread()
    previous = (signal.signal(signal.SIGTERM, raise_interrupt) if on_main
                else None)
    proc = None
    try:
        with open(log_path, "a") as f:
            f.write(f"\n+ {' '.join(cmd)}\n")
            f.flush()
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                    cwd=REPO, start_new_session=True)
            return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop_group(proc)
        return TIMED_OUT
    except BaseException:
        if proc is not None:
            _stop_group(proc)
        raise
    finally:
        if on_main:
            signal.signal(signal.SIGTERM, signal.SIG_DFL if previous is None
                          else previous)


def raise_interrupt(signum, frame):
    """A signal handler that raises the signal as a KeyboardInterrupt."""
    raise KeyboardInterrupt(f"signal {signum}")


def _stop_group(proc: subprocess.Popen) -> None:
    for sig, wait in ((signal.SIGTERM, 10), (signal.SIGKILL, None)):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            break
        try:
            proc.wait(timeout=wait)
            break
        except subprocess.TimeoutExpired:
            continue


def show_steps(steps) -> None:
    """Print launcher steps (label, argv after `python`, time limit in
    seconds or None) as the commands they run, each under `timeout <s>`
    where it has a limit."""
    for _, cmd, timeout in steps:
        limit = "" if timeout is None else f"timeout {timeout} "
        print(f"{limit}{sys.executable} {' '.join(cmd)}")


def run_steps(steps, log_path: str) -> bool:
    """Run launcher steps in order, each a `python` process from the
    repository's root after a `=== <label> <date> ===` line in the log; a
    failed step does not stop the ones after it. → whether every step
    exited 0."""
    rcs = []
    for label, cmd, timeout in steps:
        with open(log_path, "a") as f:
            f.write(f"=== {label} {time.ctime()} ===\n")
        rcs.append(run_logged([sys.executable, *cmd], log_path, timeout))
    return all(rc == 0 for rc in rcs)


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, or
    "no nvidia-smi" where it does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    return out.strip().splitlines()[0] if out.strip() else "no nvidia-smi"


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


def device_profile(fn, iters: int = ITERS):
    """(kernel ms a call of `fn` by torch.profiler, the device operations a
    call runs by name): the card's own time over `iters` calls after one
    warm-up call, without the gaps in which it waits for the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in ops) / 1e3 / iters,
            {e.key[:60]: e.count / iters for e in ops})
