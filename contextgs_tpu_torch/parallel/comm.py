"""Process groups and collectives for multi-GPU training (`torch.distributed`).

The JAX package has no module like this one: `shard_map` and `jax.lax` gave
it the mesh and its collectives. Here a `Comm` is one rank of a process
group, with the collectives the sharded step needs, each built from what
every backend in use offers (NCCL on cards, gloo on the CPU and between
ranks that share a card):

- `all_gather`: equal-size tensors concatenated rank-major on dim 0, the
  order of `jax.lax.all_gather(tiled=True)`; differentiable, its backward
  sums every rank's cotangent and returns the home rank's slice;
- `psum`, `pmean`; `psum_scatter` (an all-reduce, then the rank's slice on
  dim 0: gloo has no reduce-scatter of CUDA tensors).

Gloo carries a CUDA tensor through host memory: a `Comm` whose backend is
gloo copies CUDA tensors to the host around each collective and back, in
the code below (`_carried`), never as a fallback from an error; under
NCCL a host tensor (a generator's state) goes through the card the same
way. Booleans travel as uint8.

`spawn` starts one process a rank with the `spawn` start method (the parent
may already hold CUDA), joins a rendezvous in a temporary directory (a
`FileStore`, so concurrent runs never share a port), calls the rank body
`fn(comm, *args)` and hands each rank's return value back to the caller. A
rank that raises, dies or outlives the timeout fails the caller; the
others are then terminated. The rank body must be a module-level function
of this package, so that a child imports only torch and the port.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 600     # a collective that waits longer raises
# top-level packages a rank reports if they are imported in it
FOREIGN = ("jax", "contextgs_tpu", "PIL")


class Comm:
    """One rank of the default process group, on `device`."""

    def __init__(self, rank: int, world: int, backend: str,
                 device: torch.device):
        self.rank, self.world = rank, world
        self.backend, self.device = backend, device
        self.gather_bytes = 0     # bytes received by all_gather, forward
        self.splat_log = []       # (bytes, ms) of each step's splat gather

    def _carried(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor a collective carries: on the host for gloo, on the
        rank's card for NCCL, booleans as uint8, contiguous."""
        if self.backend == "gloo" and x.is_cuda:
            x = x.cpu()
        elif self.backend == "nccl" and not x.is_cuda:
            x = x.to(self.device)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return x.contiguous()

    def _back(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return y.to(device=like.device, dtype=like.dtype)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        y = self._carried(x)
        parts = [torch.empty_like(y) for _ in range(self.world)]
        dist.all_gather(parts, y)
        out = torch.cat(parts)
        self.gather_bytes += out.numel() * out.element_size()
        return self._back(out, x)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        y = self._carried(x)
        if y is x:
            y = y.clone()
        dist.all_reduce(y)
        return self._back(y, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[n, ...] from each rank → [world·n, ...], rank-major. Every rank
        passes the same shape. Differentiable in `x`."""
        if x.requires_grad:
            return _AllGather.apply(x, self)
        return self._gather(x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x) / self.world

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of [world·n, ...], this rank's n rows."""
        n = x.shape[0] // self.world
        return self._reduce(x)[self.rank * n:(self.rank + 1) * n]

    def barrier(self) -> None:
        dist.barrier()


class _AllGather(torch.autograd.Function):
    """all_gather whose backward sums the ranks' cotangents of the gathered
    tensor and keeps the home rank's slice: each gaussian's gradient,
    summed over every band that rasterized it, lands on its home rank."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm, ctx.n = comm, x.shape[0]
        return comm._gather(x.detach())

    @staticmethod
    def backward(ctx, grad):
        comm, n = ctx.comm, ctx.n
        return comm._reduce(grad)[comm.rank * n:(comm.rank + 1) * n], None


def init_group(rank: int, world: int, init_method: str, backend: str,
               device: torch.device) -> Comm:
    """Join the default process group as `rank` of `world`; a collective
    that waits longer than GROUP_TIMEOUT_S raises."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return Comm(rank, world, backend, device)


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def foreign_modules() -> list:
    """The modules of FOREIGN packages this process has imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def _rank_main(rank, world, backend, device_type, init_method, out_dir,
               threads):
    """A child's body: the group, `fn(comm, *args)`, the result file."""
    try:
        fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                              weights_only=False)
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
            torch.set_num_threads(threads)
        comm = init_group(rank, world, init_method, backend, device)
        try:
            result = fn(comm, *args)
        finally:
            destroy_group()
        tmp = os.path.join(out_dir, f"rank{rank}.pt.tmp")
        torch.save(result, tmp)
        os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pt"))
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, args: tuple = (), *, backend: str,
          device_type: str, timeout: float | None = None) -> list:
    """Run `fn(comm, *args)` on `world` new processes; → each rank's return
    value, by rank. Raises if a rank fails, or if `timeout` seconds pass
    first (None: no limit, a hung collective still fails after
    GROUP_TIMEOUT_S). Every child is ended before this returns."""
    ctx = multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="contextgs_ranks_")
    init_method = "file://" + os.path.join(out_dir, "rendezvous")
    threads = max(1, torch.get_num_threads() // world)
    # the call goes through a file, not the process arguments: those would
    # put its tensors in shared memory, and every rank would then update
    # one copy of the replicated parameters in place
    torch.save((fn, args), os.path.join(out_dir, "call.pt"))
    procs = [ctx.Process(
        target=_rank_main,
        args=(rank, world, backend, device_type, init_method, out_dir,
              threads),
        name=f"contextgs-rank{rank}") for rank in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"rank(s) {failed} of {world} failed:\n"
                    + _errors(out_dir, world))
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} ranks did not finish within {timeout} s:\n"
                    + _errors(out_dir, world))
            next(p for p in procs if p.exitcode is None).join(0.2)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)


def _errors(out_dir: str, world: int) -> str:
    texts = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                texts.append(f"--- rank {r}:\n{f.read()}")
    return "\n".join(texts) or "(no rank wrote an error)"


def check_collectives(comm: Comm, fail_rank: int | None = None) -> dict:
    """Rank body that runs each collective on small tensors (the port's
    tests run it on CPU ranks): the gather's order and summing backward,
    psum_scatter and booleans. Rank `fail_rank` raises instead, which must
    fail the whole spawn."""
    if comm.rank == fail_rank:
        raise RuntimeError(f"rank {comm.rank} fails on purpose")
    x = torch.tensor([10.0 * comm.rank, 10.0 * comm.rank + 1],
                     requires_grad=True)
    gathered = comm.all_gather(x)
    (grad,) = torch.autograd.grad((gathered * (comm.rank + 1)).sum(), x)
    flags = torch.arange(comm.world) == comm.rank
    return dict(gathered=gathered.detach(), grad=grad,
                psum_scatter=comm.psum_scatter(
                    torch.arange(2.0 * comm.world)),
                bools=comm.all_gather(flags))
