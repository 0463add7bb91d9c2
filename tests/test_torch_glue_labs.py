"""The glue labs `contextgs_tpu_torch/scripts/r3_micro.py` and `pack_lab.py`
against the JAX package's root `scripts/r3_micro.py` and
`scripts/pack_lab.py` on the CPU.

The JAX scripts are loaded from their files (`scripts/` is no package) and
their `main()` runs in this process with a spy in place of `timeit`: the
spy keeps each piece's name, function and inputs and times nothing. Each
JAX piece then runs once under `jax.jit` on its own inputs, and the port's
piece of the same name on the port's inputs, which must equal the JAX
inputs (so the draws are in the script's order)."""

import importlib.util
import inspect
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu.ops.rasterize import expand_and_sort as jax_sort
from contextgs_tpu.ops.rasterize import project_gaussians as jax_project
from contextgs_tpu.scene.cameras import Camera as JCamera
from contextgs_tpu_torch.ops.rasterize import TILE
from contextgs_tpu_torch.scripts import pack_lab, r3_micro

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spied_main(name):
    """{piece name: (fn, inputs)} of the JAX script's main(), and the
    module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    seen = {}

    def spy(piece, fn, *xs, iters=20):
        seen[piece] = (fn, xs)
        return 0.0

    module.timeit = spy
    module.main()
    return seen, module


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _sorted_pairs(keys, payload):
    """The (key, payload) pairs in lexicographic order: an unstable sort's
    output as a multiset of payloads for each key."""
    keys, payload = _np(keys), _np(payload)
    i = np.lexsort((payload, keys))
    return keys[i], payload[i]


# ---------------------------------------------------------------- r3_micro

@pytest.fixture(scope="module")
def r3():
    seen, _ = _spied_main("r3_micro")
    ours = {name: (fn, xs) for name, fn, xs in r3_micro.pieces("cpu")}
    return seen, ours


R3_NAMES = ["xpose [16,Bp]->[Bp,16] (barrier)",
            "perm row-gather [B from Bp+1,16]", "cumsum [B,16] axis0",
            "boundary gather [G+1 from B+1,16]", "inv_order gather [G,16]",
            "pack row-gather [Bp from G+1,16]", "pack gather + .T barrier",
            "sort u32 [1.25M] + 1 payload",
            "sort PRESORTED u32 [1.25M] + 1 payload",
            "inversion sort [1.25M] (i32 key + iota)",
            "ffill scatter+cumsum (1 word)", "scatter 200k->786k",
            "cumsum [786k] i32"]


def test_r3_micro_has_the_jax_pieces_in_order(r3):
    seen, ours = r3
    assert list(seen) == R3_NAMES
    assert [n for n in ours if ": " not in n] == R3_NAMES
    for name in R3_NAMES[7:10]:
        assert f"{name}: sort" in ours and f"{name}: payload gather" in ours


@pytest.mark.parametrize("name", R3_NAMES)
def test_r3_micro_piece_matches_jax(name, r3):
    """Same inputs bit for bit (the u32 keys through `unsigned_keys`);
    outputs exact for the gathers, the transposes, the integer scatter,
    cumsum and forward fill; the sorts' keys exact and their payloads
    equal as a multiset for each key (both sorts are unstable); the
    float32 cumsum down 786,432 rows within `r3_micro.cumsum_tolerance`
    at each output (8·2^-24 times the rounding scale of a sequential or a
    tree scan, about 0.06 at the last rows against values near 900)."""
    seen, ours = r3
    jfn, jxs = seen[name]
    fn, xs = ours[name]
    unsigned = name.startswith("sort")
    for a, b in zip(jxs, xs):
        b = r3_micro.unsigned_keys(b) if unsigned and b is xs[0] else _np(b)
        assert np.array_equal(np.asarray(a), b), name
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jfn)(*jxs))
    got = fn(*xs)
    if "sort" in name:
        keys = r3_micro.unsigned_keys(got[0]) if unsigned else _np(got[0])
        assert np.array_equal(keys, want[0])
        for a, b in zip(_sorted_pairs(keys, got[1]),
                        _sorted_pairs(*want)):
            assert np.array_equal(a, b)
    elif name == "cumsum [B,16] axis0":
        bound = _np(r3_micro.cumsum_tolerance(xs[0], 0))
        assert (np.abs(_np(got).astype(np.float64) - want) <= bound).all()
    else:
        assert _np(got).dtype == want.dtype
        assert np.array_equal(_np(got), want), name


def test_r3_micro_cumsum_tolerance_fails_wrong_scans(r3):
    """The cumsum's tolerance holds the exact prefix sums' float32 values
    and refuses a scan shifted by one row at nearly every output, one
    zeroed from row 100 on, and one that drops a single row of the 786,432
    in the last half."""
    x = r3[1]["cumsum [B,16] axis0"][1][0]
    exact = torch.cumsum(x.double(), 0)
    bound = r3_micro.cumsum_tolerance(x, 0)
    assert bool(((exact.float().double() - exact).abs() <= bound).all())
    shifted = torch.cat([exact.new_zeros(1, 16), exact[:-1]])
    assert float(((shifted - exact).abs() > bound).double().mean()) > 0.85
    zeroed = exact.clone()
    zeroed[100:] = 0
    dropped = exact.clone()
    dropped[500_000:] -= x[500_000].double()
    for wrong in (zeroed, dropped):
        assert not bool(((wrong - exact).abs() <= bound).all())


def test_r3_micro_split_sorts_compose(r3):
    """The ': sort' and ': payload gather' halves of each sort give the
    whole piece's output (the gather's indices are its sort's)."""
    _, ours = r3
    for name in R3_NAMES[7:10]:
        fn, xs = ours[name]
        keys, payload = fn(*xs)
        sfn, sxs = ours[f"{name}: sort"]
        values, indices = sfn(*sxs)
        gfn, gxs = ours[f"{name}: payload gather"]
        assert torch.equal(values, keys)
        assert torch.equal(gfn(xs[1], indices), gfn(*gxs))
        assert np.array_equal(*(_sorted_pairs(keys, p)[1]
                                for p in (payload, gfn(*gxs))))


def test_r3_micro_keys_keep_the_unsigned_order():
    """The sign-flipped int32 view orders u32 keys as JAX orders them,
    across the sign bit too."""
    keys = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 5, 2 ** 31 + 7],
                    np.uint32)
    got = torch.sort(torch.from_numpy(r3_micro.signed_keys(keys))).values
    assert np.array_equal(r3_micro.unsigned_keys(got),
                          np.asarray(jnp.sort(jnp.asarray(keys))))


# ---------------------------------------------------------------- pack_lab

CUT = dict(n_gauss=20_000, width=320, height=180)


@pytest.fixture(scope="module")
def pack():
    seen, _ = _spied_main("pack_lab")
    return seen


def _jax_frame(n_gauss, width, height):
    """The bench draws through the JAX package's projection and binning at
    a cut frame: (rows [G, 9], instances)."""
    rng = np.random.default_rng(0)
    means = np.stack([rng.uniform(-3, 3, n_gauss), rng.uniform(-2, 2, n_gauss),
                      rng.uniform(2.0, 12.0, n_gauss)], 1).astype(np.float32)
    scales = rng.uniform(0.004, 0.02, (n_gauss, 3)).astype(np.float32)
    quats = rng.normal(size=(n_gauss, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = rng.uniform(0, 1, (n_gauss, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, n_gauss).astype(np.float32)
    cam = JCamera(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3), fov_x=1.2,
                  fov_y=2 * math.atan(math.tan(0.6) * height / width),
                  image=None, width=width, height=height)
    wv, fp = jnp.asarray(cam.world_view), jnp.asarray(cam.full_proj)
    proj = jax.jit(lambda m, s, q, o: jax_project(
        m, s, q, wv, fp, cam.tanfovx, cam.tanfovy, width, height, TILE,
        opacities=o))(*map(jnp.asarray, (means, scales, quats, opac)))
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    inst = jax.jit(lambda p: jax_sort(p, tiles_x, tiles_y, 1 << 17,
                                      align=128))(proj)
    rows = jnp.concatenate([proj.means2d, proj.conics,
                            jnp.asarray(opac)[:, None], jnp.asarray(colors)],
                           axis=1)
    return rows, inst


def test_pack_lab_bench_frame_matches_jax(pack):
    """At the JAX script's own frame (200k gaussians, 1280x720): the port's
    demand is JAX's instance count (547,648), its depth ranks of the
    instances, in the port's (tile, depth) order, are JAX's `rank_aligned`
    without its pads, and the static table it prints is JAX's b_pad."""
    f = pack_lab.frame("cpu")
    regroup_xs = pack["regroup width 9"][1]
    seg_bounds = np.asarray(regroup_xs[2])
    rank_aligned = np.asarray(inspect.getclosurevars(
        pack["gather16 [b_pad]"][0]).nonlocals["rank"])
    assert f.inst.demand == int(seg_bounds[-1]) == 547_648
    assert pack_lab.jax_table_size(80 * 45) == rank_aligned.shape[0]
    valid = rank_aligned < pack_lab.G
    assert np.array_equal(_np(f.rank), rank_aligned[valid])
    assert pack_lab.monotone_fraction(f.rank) == pytest.approx(
        float(np.mean(np.diff(rank_aligned[valid]) > 0)), abs=0)


@pytest.fixture(scope="module")
def cut(pack):
    rows, inst = _jax_frame(**CUT)
    return pack_lab.frame("cpu", **CUT), rows, inst


def test_pack_lab_cut_frame_demand_and_gathers(cut, pack):
    """At a cut frame (20k gaussians, 320x180): the port's demand equals
    JAX's `demand`, prep16 equals JAX's prep16 on JAX's rows within the
    projections' 2e-5, and gather16 equals JAX's rows_rank[rank_aligned]
    at the valid slots."""
    f, jrows, inst = cut
    assert f.inst.demand == int(inst.demand) > 0
    assert np.array_equal(_np(f.order), np.asarray(inst.order))
    jprep = pack["prep16 (order gather + pads)"][0]
    want16 = np.asarray(jax.jit(jprep)(jrows, inst.order))
    got16 = pack_lab.prep16(f.rows, f.order)
    np.testing.assert_allclose(_np(got16), want16, rtol=2e-5, atol=2e-5)
    ra = np.asarray(inst.rank_aligned)
    gathered = dict((n, fn(*xs)) for n, fn, xs in pack_lab.pieces(f))
    np.testing.assert_allclose(_np(gathered["gather16 [B]"]),
                               want16[ra[ra < CUT["n_gauss"]]],
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(gathered["gather16+T"],
                       gathered["gather16 [B]"].t().contiguous())


@pytest.mark.parametrize("w", [9, 16])
def test_pack_lab_regroup_matches_jax(w, cut, pack):
    """JAX's regroup (from the script's main) fed the lab's per-instance
    rows at its aligned slots, zeros at its pads, against the port's three
    routes. The bound is `pack_lab.regroup_tolerance` (8·2^-24 times the
    rounding scale of a scan-based or any-order segment sum) in the
    port's instance order for each route against a float64 sum, that
    plus the same in JAX's depth order against JAX, twice the port's
    between two routes."""
    f, _, inst = cut
    jfn = pack[f"regroup width {w}"][0]
    ra = np.asarray(inst.rank_aligned)
    valid = np.flatnonzero(ra < CUT["n_gauss"])
    g = _np(f.grads)
    g16 = np.zeros((16, ra.shape[0]), np.float32)
    g16[:, valid] = g.T
    want = np.asarray(jax.jit(jfn)(jnp.asarray(g16), inst.perm,
                                   inst.seg_bounds, inst.inv_order))
    exact = np.zeros((CUT["n_gauss"], 16))
    np.add.at(exact, _np(f.inst.gauss_ids), g.astype(np.float64))
    ids, n = f.inst.gauss_ids, CUT["n_gauss"]
    ours = _np(pack_lab.regroup_tolerance(f.grads, ids, n))
    inv_order = torch.empty_like(f.order)
    inv_order[f.order] = torch.arange(n)
    theirs = _np(pack_lab.regroup_tolerance(f.grads, f.rank, n)[inv_order])
    got = {name: _np(fn(*xs)) for name, fn, xs in pack_lab.pieces(f)
           if name.startswith(f"regroup width {w}")}
    assert len(got) == 3
    for name, x in got.items():
        assert x.shape == want.shape == (n, 9), name
        assert (np.abs(x - exact[:, :9]) <= ours).all(), name
        assert (np.abs(x - want) <= ours + theirs).all(), name
    for a, b in zip(list(got.values()), list(got.values())[1:]):
        assert (np.abs(a - b) <= 2 * ours).all()


def test_pack_lab_regroup_tolerance_fails_wrong_sums(cut):
    """The regroup's tolerance refuses sums whose segment bounds are off
    by one instance, and sums that miss one instance of a gaussian."""
    f, _, _ = cut
    ids, n = f.inst.gauss_ids, CUT["n_gauss"]
    g = f.grads.double()
    bound = pack_lab.regroup_tolerance(f.grads, ids, n)
    sorted_g = g[torch.sort(ids, stable=True).indices]
    cs = torch.cat([g.new_zeros(1, 16), torch.cumsum(sorted_g, 0)])
    bounds = pack_lab.segment_bounds(ids, n)
    exact = (cs[bounds[1:]] - cs[bounds[:-1]])[:, :9]
    late = bounds.clone()
    late[1:-1] = (late[1:-1] + 1).clamp(max=ids.numel())
    wrong = {"bounds off by one": (cs[late[1:]] - cs[late[:-1]])[:, :9]}
    missing = exact.clone()
    j = int(ids[0])
    missing[j] -= g[0, :9]
    wrong["one instance missing"] = missing
    for name, x in wrong.items():
        off = (x - exact).abs() > bound
        assert bool(off.any()), name
    assert float(((wrong["bounds off by one"] - exact).abs() > bound)
                 .any(1).double()[bounds[1:] > bounds[:-1]].mean()) > 0.5
