"""K5 and K6, the slab transposes, and the layout lab around them (port of
`scripts/xpose_lab.py`, replacing its Pallas kernels `inkernel_T` and
`inkernel_T2`).

The lab weighs layouts of the instance tables: component-major [16, B]
against row-major [B, 16] rows, blocked [nc, C, 16] slabs and their
transpose, a 16-wide against a 9-wide row gather, and the prefix sums and
gathers of the gradient regroup. Its Pallas kernels transpose a [C, 16]
block in the kernel; here `transpose_slabs(x, variant)` computes
x.transpose(1, 2) of a contiguous [nc, 128, 16] float32 tensor into a new
[nc, 16, 128] one with `csrc/xpose.cu`: variant "smem" launches K5
(`transpose_slab_smem`, one block a slab through padded shared memory),
"vec" K6 (`transpose_slab_vec`, float4 loads and stores, 8 slabs a block).
On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version `transpose_slabs_reference`. `launches[variant]`
counts each kernel's launches in this process.

The lab's other rows are plain torch calls at the lab's shapes. Unlike the
lab, nothing here catches a failure: a build or launch that fails raises.

    python -m contextgs_tpu_torch.scripts.xpose_lab
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from contextgs_tpu_torch.device import resolve_device
from contextgs_tpu_torch.ops.cuda_build import c_function, launch
from contextgs_tpu_torch.scripts import ITERS, time_ms

SOURCE = Path(__file__).resolve().parent / "csrc" / "xpose.cu"
C, K = 128, 16              # a slab is [C, K]: C instances of 16 components
KERNELS = {"smem": "transpose_slab_smem", "vec": "transpose_slab_vec"}
B = 1_074_432               # the lab's b_pad at bench shapes
G = 200_000                 # gaussians
BUD = 786_432               # the lab's instance budget

launches = dict.fromkeys(KERNELS, 0)


def transpose_slabs_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: x [nc, C, K] → x.transpose(1, 2), contiguous."""
    return x.transpose(1, 2).contiguous()


def transpose_slabs(x: torch.Tensor, variant: str) -> torch.Tensor:
    """x [nc, 128, 16] f32 contiguous → [nc, 16, 128] f32, by K5 ("smem") or
    K6 ("vec") on the card."""
    if variant not in KERNELS:
        raise ValueError(f"transpose_slabs: variant must be one of "
                         f"{sorted(KERNELS)}, got {variant!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"transpose_slabs: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[1:] != (C, K):
        raise ValueError(f"transpose_slabs: x must be a float32 [nc,{C},{K}] "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("transpose_slabs: x must be contiguous")
    if x.device.type == "cpu":
        return transpose_slabs_reference(x)
    if x.data_ptr() % 16:
        raise ValueError("transpose_slabs: x must be 16-byte aligned")
    nc = x.shape[0]
    out = torch.empty((nc, K, C), dtype=x.dtype, device=x.device)
    if nc:
        fn = c_function(SOURCE, KERNELS[variant],
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p])
        err = launch(fn, x.device, x.data_ptr(), out.data_ptr(), nc)
        if err != 0:
            raise RuntimeError(f"transpose_slabs: kernel launch of "
                               f"{KERNELS[variant]} failed with CUDA error "
                               f"{err}")
        launches[variant] += 1
    return out


def regroup16(xb16, perm, segb, inv):
    """The lab's gradient regroup (`:82-88`): gather the budget's rows in
    depth order, prefix-sum them, difference at the segment bounds, gather
    by rank, keep 9 components."""
    bud = perm.numel()
    g_depth = xb16[perm]
    cs = torch.cat([torch.zeros((1, K), dtype=xb16.dtype, device=xb16.device),
                    torch.cumsum(g_depth, 0)])
    cs_b = cs[segb.clamp(0, bud)]
    return (cs_b[1:] - cs_b[:-1])[inv][:, :9]


def perm_mask(xb16, perm, inuse):
    """The lab's in-use select and gather (`:93-95`): slots not in use read
    the last row."""
    return xb16[torch.where(inuse[perm], perm, xb16.shape[0] - 1)]


def lab_inputs(seed: int = 0, *, b: int = B, g: int = G, bud: int = BUD,
               device=None) -> dict:
    """The lab's arrays (`:53-77`), drawn in its order from
    `np.random.default_rng(seed)`; indices int32, as in the lab."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    nc = b // C

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = dict(
        x_cm=put(rng.normal(size=(16, b)).astype(np.float32)),
        x_rm=put(rng.normal(size=(b, 16)).astype(np.float32)),
        x_3a=put(rng.normal(size=(nc, 16, C)).astype(np.float32)),
        x_3b=put(rng.normal(size=(nc, C, 16)).astype(np.float32)),
        rows16=put(rng.normal(size=(g + 1, 16)).astype(np.float32)),
        idx=put(rng.integers(0, g, b).astype(np.int32)))
    out.update(
        perm=put(rng.permutation(b)[:bud].astype(np.int32)),
        segb=put(np.sort(rng.integers(0, bud, g + 1)).astype(np.int32)),
        inv=put(rng.permutation(g).astype(np.int32)),
        xb16=put(rng.normal(size=(b + 1, 16)).astype(np.float32)),
        inuse=put(rng.random(b + 1) < 0.9))
    return out


def lab_rows(inp: dict) -> list:
    """(name, call) of each row of the lab's table, in its order."""
    x_cm, x_rm, x_3a, x_3b = inp["x_cm"], inp["x_rm"], inp["x_3a"], inp["x_3b"]
    rows16, idx, xb16 = inp["rows16"], inp["idx"], inp["xb16"]
    bud = inp["perm"].numel()
    nc = x_3b.shape[0]
    return [
        ("T global [16,B]->[B,16]", lambda: x_cm.t().contiguous()),
        ("T global [B,16]->[16,B]", lambda: x_rm.t().contiguous()),
        ("T slice9 [16,B]->[B,9]", lambda: x_cm[:9].t().contiguous()),
        ("T blocked [nc,16,C]->[nc,C,16]",
         lambda: x_3a.transpose(1, 2).contiguous()),
        ("T blocked [nc,C,16]->[nc,16,C]",
         lambda: transpose_slabs_reference(x_3b)),
        ("gather rows16 [B]", lambda: rows16[idx]),
        ("gather rows16->9 [B]", lambda: rows16[idx, :9]),
        ("gather+reshape3d", lambda: rows16[idx].reshape(nc, C, K)),
        (f"cumsum [{bud},16] ax0", lambda: torch.cumsum(xb16[:bud], 0)),
        (f"cumsum [{bud},9] ax0", lambda: torch.cumsum(xb16[:bud, :9], 0)),
        ("regroup16 full (gather+cs+2xgather)",
         lambda: regroup16(xb16, inp["perm"], inp["segb"], inp["inv"])),
        ("perm in_use-select + gather",
         lambda: perm_mask(xb16, inp["perm"], inp["inuse"])),
        ("K5 transpose_slab_smem [nc,C,16]->[nc,16,C]",
         lambda: transpose_slabs(x_3b, "smem")),
        ("K6 transpose_slab_vec [nc,C,16]->[nc,16,C]",
         lambda: transpose_slabs(x_3b, "vec")),
    ]


def run_all(device=None, *, b: int = B, g: int = G, bud: int = BUD,
            iters: int = ITERS, seed: int = 0) -> dict:
    """{row name: ms a call} of the lab's table at its shapes."""
    dev = resolve_device(device)
    inp = lab_inputs(seed, b=b, g=g, bud=bud, device=dev)
    return {name: time_ms(call, dev, iters) for name, call in lab_rows(inp)}


def main(device=None) -> dict:
    """Print the lab's table, one row a line, ms a call."""
    dev = resolve_device(device)
    table = run_all(dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"xpose_lab on {where}: ms a call, mean of {ITERS} calls")
    for name, ms in table.items():
        print(f"{name:46s} {ms:8.4f} ms")
    return table


if __name__ == "__main__":
    main()
