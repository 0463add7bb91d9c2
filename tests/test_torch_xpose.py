"""The port's slab transposes K5 and K6 and the layout lab's torch rows
(`contextgs_tpu_torch/scripts/xpose_lab.py`; on the CPU the wrapper runs the
plain version) against the JAX lab of `scripts/xpose_lab.py`: its in-kernel
transposes `inkernel_T` and `inkernel_T2`, closures inside the lab's `main`,
rebuilt from their one-line bodies with the lab's BlockSpecs (`:100-133`)
and run in interpret mode, and its regroup and in-use gather (`:82-97`).
A transpose moves values without arithmetic, so the comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from contextgs_tpu_torch.scripts import xpose_lab as txl

torch.set_num_threads(1)

C = txl.C


def _lab_transpose(x, swap):
    """The lab's inkernel_T (swap False) or inkernel_T2 (swap True)."""
    def tkern(a_ref, o_ref):
        o_ref[0] = a_ref[0].T

    def tkern2(a_ref, o_ref):
        o_ref[0] = jnp.swapaxes(a_ref[0], 0, 1)

    nc = x.shape[0]
    return np.asarray(pl.pallas_call(
        tkern2 if swap else tkern, grid=(nc,),
        in_specs=[pl.BlockSpec((1, C, 16), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 16, C), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nc, 16, C), jnp.float32),
        interpret=True)(jnp.asarray(x)))


@pytest.mark.parametrize("nc", [1, 13])          # 13: ragged for K6's 8
@pytest.mark.parametrize("variant", sorted(txl.KERNELS))
def test_transpose_slabs_match_the_jax_lab(variant, nc):
    x = np.random.default_rng(nc).normal(size=(nc, C, 16)).astype(np.float32)
    before = dict(txl.launches)
    got = txl.transpose_slabs(torch.from_numpy(x), variant)
    assert txl.launches == before                # the CPU runs the plain one
    assert got.shape == (nc, 16, C) and got.is_contiguous()
    want = _lab_transpose(x, swap=variant == "vec")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x.transpose(0, 2, 1))


def test_regroup_and_in_use_gather_match_the_jax_lab():
    """The lab's regroup16 and perm_mask bodies in JAX against the port's,
    on the lab's arrays at a small size."""
    b, g, bud = 128 * 24, 500, 2000
    inp = txl.lab_inputs(4, b=b, g=g, bud=bud, device="cpu")
    xb16, perm, segb, inv, inuse = (jnp.asarray(inp[k].numpy()) for k in (
        "xb16", "perm", "segb", "inv", "inuse"))
    g_depth = xb16[perm]
    cs = jnp.concatenate([jnp.zeros((1, 16), jnp.float32),
                          jnp.cumsum(g_depth, axis=0)])
    cs_b = cs[jnp.clip(segb, 0, bud)]
    want_regroup = ((cs_b[1:] - cs_b[:-1])[inv][:, :9])
    want_mask = xb16[jnp.where(inuse[perm], perm, b)]
    got_regroup = txl.regroup16(inp["xb16"], inp["perm"], inp["segb"],
                                inp["inv"])
    assert got_regroup.shape == (g, 9)
    # cumsum order differs between XLA and torch: float32 rounding of sums
    # of up to `bud` N(0,1) values
    np.testing.assert_allclose(got_regroup.numpy(), np.asarray(want_regroup),
                               atol=1e-3)
    np.testing.assert_array_equal(
        txl.perm_mask(inp["xb16"], inp["perm"], inp["inuse"]).numpy(),
        np.asarray(want_mask))


def test_lab_rows_run_on_the_cpu():
    before = dict(txl.launches)
    table = txl.run_all("cpu", b=128 * 8, g=100, bud=600, iters=1)
    assert txl.launches == before
    assert len(table) == 14 and min(table.values()) > 0
    assert list(table)[-2:] == [
        "K5 transpose_slab_smem [nc,C,16]->[nc,16,C]",
        "K6 transpose_slab_vec [nc,C,16]->[nc,16,C]"]


def test_transpose_slabs_rejects_bad_inputs():
    x = torch.zeros((3, C, 16))
    for bad, variant, match in (
            (x, "tma", "variant must be one of"),
            (x.to("meta"), "smem", "unsupported device"),
            (x.double(), "vec", "float32"),
            (x[:, :64], "vec", r"\[nc,128,16\]"),
            (x[None], "smem", r"\[nc,128,16\]"),
            (x.transpose(0, 1).contiguous().transpose(0, 1), "smem",
             "contiguous")):
        with pytest.raises(ValueError, match=match):
            txl.transpose_slabs(bad, variant)
