"""The port's kernel lab K4 (`contextgs_tpu_torch/scripts/kvariants.py`; its
wrapper on the CPU runs the plain version) against the JAX lab's Pallas
variants of `scripts/kvariants.py`, built with the lab's own grid spec and
run in interpret mode, on the same numpy tables.

Tolerances: 2e-5 absolute on rgb and T (the port's rasterize tests), 1e-5
relative on the sinks of v1-v3. The Pallas lab takes the power in
tile-centred coordinates through a bf16x3 matrix product and T in log space,
so the two agree to float32 rounding, not bit for bit.

The port's variants are stages of K1 and carry T across chunks; the lab's
do not, so v3 is held on single-chunk tiles and v4 where no pixel's T falls
below t_eps. Two named tests show the differences.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from contextgs_tpu_torch.ops.rasterize import reference as tref
from contextgs_tpu_torch.scripts import kvariants as tkv

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OUTC = 6       # the lab writes rgb, T, log T and a watermark a pixel
# (tiles_x, tiles_y, chunks of the first tiles): dense covers every pixel
# many times, so multi-chunk tiles saturate; sparse spreads the same lists
# over a view 16 tiles wide, where no pixel's T falls below t_eps
CHUNKS = [1, 2, 8, 0, 1, 2, 1, 0]
CASES = {"dense": (4, 2), "sparse": (16, 8)}


@pytest.fixture
def lab(monkeypatch, tmp_path):
    """The JAX lab module, loaded from its file with its compile cache under
    tmp_path and its stale OUTC (the package's is 4 now) set to the 6
    channels it writes."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(sys, "path", list(sys.path))  # the lab prepends
    spec = importlib.util.spec_from_file_location(
        "kvariants_lab", REPO / "scripts" / "kvariants.py")
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    monkeypatch.setattr(kv, "OUTC", OUTC)
    return kv


def _case(name):
    tiles_x, tiles_y = CASES[name]
    rows, ids, bounds = tkv.lab_inputs(CHUNKS, len(CHUNKS), seed=3,
                                       tiles_x=tiles_x, tiles_y=tiles_y,
                                       budget=2048, device="cpu")
    return rows, ids, bounds, 16 * tiles_x, 16 * tiles_y


def _lab_blend(kv, level, rows, bounds, width, height):
    """The lab's variant at `level` (its grid spec, `:113-124`) in interpret
    mode → (rgb [3,H,W], T [H,W]) as torch tensors."""
    tiles_x, tiles_y = width // 16, height // 16
    n_steps = -(-tiles_x * tiles_y // kv.TB)
    b = bounds.numpy()
    b = np.concatenate([b, np.full(n_steps * kv.TB + 1 - b.size, b[-1])])
    packed = np.zeros((kv.PACK, rows.shape[0]), np.float32)
    packed[:9] = rows.numpy().T
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_steps,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((kv.TB, kv.PIX, OUTC), lambda i, b: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, kv.PACK, tkv.CHUNK), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))])
    f = pl.pallas_call(
        kv.make_kernel(level, tkv.CHUNK, tiles_x, 16), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n_steps * kv.TB, kv.PIX, OUTC),
                                       jnp.float32), interpret=True)
    out = torch.from_numpy(np.array(f(jnp.asarray(b), jnp.asarray(packed))))
    out = out[:tiles_x * tiles_y]
    rgb = tref._untile(out[..., :3].permute(2, 0, 1), tiles_x, 16, width,
                       height)
    return rgb, tref._untile(out[..., 3], tiles_x, 16, width, height)


def _tile_mask(bounds, width, height, keep):
    """[H,W] bool: pixels of the tiles whose list length satisfies keep."""
    lens = (bounds[1:] - bounds[:-1]).to(torch.int64)
    tiles_x = width // 16
    return tref._untile(keep(lens)[:, None].expand(-1, 256), tiles_x, 16,
                        width, height)


def _sink_close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("level", range(5))
def test_variant_matches_the_jax_lab(lab, level, case):
    """v0-v2 on every tile; v3 on single-chunk tiles; v4 on every tile of
    the sparse case, where no pixel saturates (asserted), and on the
    single-chunk tiles of the dense one."""
    rows, ids, bounds, w, h = _case(case)
    before = list(tkv.launches)
    got_rgb, got_t, got_last = tkv.blend_variant(level, rows, ids, bounds, w,
                                                 h)
    assert tkv.launches == before                 # the CPU runs the plain one
    want_rgb, want_t = _lab_blend(lab, level, rows, bounds, w, h)
    assert got_rgb.shape == (3, h, w) and got_last.dtype == torch.int32
    one_chunk = _tile_mask(bounds, w, h, lambda n: n == tkv.CHUNK)
    if level <= 2:
        _sink_close(got_rgb, want_rgb)
        np.testing.assert_array_equal(got_t.numpy(), want_t.numpy())
        assert int(got_last.abs().max()) == 0
        assert level == 0 or float(want_rgb.abs().max()) > 0
    elif level == 3:
        _sink_close(got_rgb[:, one_chunk], want_rgb[:, one_chunk])
        assert float(want_rgb[:, one_chunk].max()) > 0
    else:
        pairs = tref.blend_tiles_reference(rows, ids, bounds, w, h, w // 16,
                                           count_pairs=True)[3]
        saturated = pairs["tested"] > pairs["blended"]
        assert saturated == (case == "dense")
        mask = one_chunk if saturated else torch.ones_like(one_chunk)
        np.testing.assert_allclose(got_rgb[:, mask].numpy(),
                                   want_rgb[:, mask].numpy(), atol=2e-5)
        np.testing.assert_allclose(got_t[mask].numpy(), want_t[mask].numpy(),
                                   atol=2e-5)
        assert float(got_rgb.max()) > 0.1


def test_lab_v3_restarts_transmittance_at_each_chunk(lab):
    """The lab's v3 returns before its T update (`kvariants.py:88`), so every
    chunk starts at T = 1: its sink on a two-chunk tile is the sum of the
    port's v3 sinks of the two chunks as lists of their own, not the port's
    sink of the whole list, which carries T."""
    rows, ids, bounds, w, h = _case("dense")
    two = 1                                       # CHUNKS[1] == 2
    start, n_tiles = int(bounds[two]), bounds.numel() - 1

    def only_tile(first, end):          # tile `two` lists [first, end)
        tb = torch.full((n_tiles + 1,), end, dtype=torch.int32)
        tb[:two + 1] = first
        return tkv.blend_variant_reference(3, rows, ids, tb, w, h)[0]

    mid, end = start + tkv.CHUNK, start + 2 * tkv.CHUNK
    sinks = [only_tile(start, end), only_tile(start, mid),
             only_tile(mid, end)]
    want = _lab_blend(lab, 3, rows, bounds, w, h)[0]
    in_tile = _tile_mask(bounds, w, h,
                         lambda n: torch.arange(n.numel()) == two)
    carried, first, second = (s[:, in_tile] for s in sinks)
    _sink_close(first + second, want[:, in_tile])
    assert float((carried - want[:, in_tile]).abs().max()) \
        > 0.01 * float(want[:, in_tile].max())


def test_lab_v4_blends_a_finished_pixel_at_a_chunk_boundary(lab):
    """The lab's v4 carries T as the last included value and keeps blending
    in the next chunk: slots 0-2 finish the pixel (slot 2 is excluded), and
    slot 128, the next chunk's first, bright green, is blended by the lab
    (G of the order of 1000 · 0.3 · 2e-4 = 0.06) but not by the port's v4, which is K1."""
    rows = np.zeros((2 * tkv.CHUNK, 9), np.float32)
    rows[:, 0:2] = 7.5
    rows[:, 2] = rows[:, 4] = 1e-4
    rows[:3, 5] = [0.99, 0.98, 0.99]
    rows[:3, 6] = 1.0
    rows[tkv.CHUNK, 5] = 0.3
    rows[tkv.CHUNK, 7] = 1000.0
    rows = torch.from_numpy(rows)
    ids = torch.arange(2 * tkv.CHUNK, dtype=torch.int32)
    bounds = torch.tensor([0, 2 * tkv.CHUNK], dtype=torch.int32)
    got = tkv.blend_variant(4, rows, ids, bounds, 16, 16)
    want_g = _lab_blend(lab, 4, rows, bounds, 16, 16)[0][1]
    assert float(got[0][1].abs().max()) == 0.0 and (got[2] == 2).all()
    assert float(want_g.min()) > 0.05


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_v3_v4_follow_blend_tiles_reference(case):
    """v4's plain version is blend_tiles_reference; v3's T and last_contrib
    are its, and its sink is 1e-30 Σ alpha·T: the rgb of unit colours."""
    rows, ids, bounds, w, h = _case(case)
    want = tref.blend_tiles_reference(rows, ids, bounds, w, h, w // 16)
    v4 = tkv.blend_variant_reference(4, rows, ids, bounds, w, h)
    v3 = tkv.blend_variant_reference(3, rows, ids, bounds, w, h)
    for a, b in zip(v4, want):
        assert torch.equal(a, b)
    assert torch.equal(v3[1], want[1]) and torch.equal(v3[2], want[2])
    weights = 1.0 - want[1]            # Σ alpha·T = 1 - T, to rounding
    np.testing.assert_allclose((v3[0] / tkv.SINK).numpy(),
                               weights.expand(3, -1, -1).numpy(), atol=1e-5)


def test_lab_inputs_follow_the_lab_recipe():
    rows, ids, bounds = tkv.lab_inputs(8, 3, tiles_x=4, tiles_y=2, budget=2048,
                                       device="cpu")
    assert rows.shape == (2048 + 8 * 128, 9) and rows.dtype == torch.float32
    assert torch.equal(ids, torch.arange(rows.shape[0], dtype=torch.int32))
    assert bounds.tolist() == [0, 1024, 2048, 3072] + [3072] * 5
    r = rows.numpy()
    assert r[:, 0].max() < 64 and r[:, 1].max() < 32 and r.min() >= 0
    assert (r[:, [2, 4]] == np.float32(0.1)).all() and (r[:, 3] == 0).all()
    assert 0.2 <= r[:, 5].min() and r[:, 5].max() <= 0.9
    first = np.random.default_rng(0).uniform(0, 64, rows.shape[0])
    np.testing.assert_array_equal(r[:, 0], first.astype(np.float32))
    with pytest.raises(ValueError, match="exceed"):
        tkv.lab_inputs(9, 8, tiles_x=4, tiles_y=2, budget=0, device="cpu")


def test_run_all_on_the_cpu_runs_the_plain_versions():
    before = list(tkv.launches)
    table = tkv.run_all("cpu", tiles_x=4, tiles_y=2, budget=1024, iters=1)
    assert tkv.launches == before
    assert list(table) == ["1x8", "2x8", "8x1"]
    assert all(len(ms) == 5 and min(ms) > 0 for ms in table.values())


def test_blend_variant_rejects_bad_inputs():
    rows, ids, bounds, w, h = _case("dense")
    for change, match in (
            (dict(level=5), "level must be 0-4"),
            (dict(rows=rows.to("meta")), "unsupported device"),
            (dict(rows=rows.double()), "rows must be a contiguous"),
            (dict(rows=rows[:, :8]), r"rows must be \[G,9\]"),
            (dict(gauss_ids=ids.long()), "gauss_ids must be a contiguous"),
            (dict(tile_bounds=bounds[:4]), "tile_bounds")):
        args = dict(dict(level=2, rows=rows, gauss_ids=ids,
                         tile_bounds=bounds, width=w, height=h), **change)
        with pytest.raises(ValueError, match=match):
            tkv.blend_variant(**args)


def test_lab_entry_points_raise_without_a_card(monkeypatch):
    """No silent CPU fallback: without a card the labs raise, unless the
    caller passes device="cpu"."""
    from contextgs_tpu_torch.scripts import xpose_lab as txl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tkv.run_all, tkv.main, txl.run_all, txl.main,
                 lambda: tkv.lab_inputs(1, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
