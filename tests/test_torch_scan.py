"""The port's lane prefix sum (K3's wrapper on the CPU, which runs its plain
version) against the JAX package's Pallas `lane_cumsum` in interpret mode,
at the shapes and cases of `tests/test_scan.py`; and the wrapper's input
checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu.ops.scan import lane_cumsum as jax_lane_cumsum
from contextgs_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)


def _both(x, exclusive=False):
    want = np.asarray(jax_lane_cumsum(jnp.asarray(x), exclusive=exclusive))
    before = tscan.launches
    got = tscan.lane_cumsum(torch.from_numpy(x), exclusive=exclusive)
    assert tscan.launches == before          # the CPU runs the plain version
    return got.numpy(), want


def test_lane_cumsum_i32_wraps_exactly(rng):
    x = rng.integers(-(2**28), 2**28, (2, 100_000)).astype(np.int32)
    got, want = _both(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.cumsum(x, axis=1, dtype=np.int32))
    wraps = np.cumsum(x.astype(np.int64), axis=1)
    assert (np.abs(wraps) > 2**31).any()     # the sums do wrap


def test_lane_cumsum_f32(rng):
    x = rng.normal(size=(8, 33_000)).astype(np.float32)
    got, want = _both(x)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64), axis=1),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_lane_cumsum_1d_exclusive(rng, dtype):
    x = rng.integers(0, 1000, 5000).astype(dtype)
    got, want = _both(x, exclusive=True)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got.shape == (5000,)


@pytest.mark.parametrize("n", [1, 127, 129, 4097])
@pytest.mark.parametrize("exclusive", [False, True])
def test_lane_cumsum_odd_sizes(rng, n, exclusive):
    x = rng.integers(0, 100, (8, n)).astype(np.int32)
    got, want = _both(x, exclusive)
    np.testing.assert_array_equal(got, want)


def test_lane_cumsum_uint32_as_int32_bits(rng):
    x = rng.integers(0, 2**32, (3, 1000), dtype=np.uint64).astype(np.uint32)
    got = tscan.lane_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy().view(np.uint32),
        np.cumsum(x, axis=1, dtype=np.uint32))


def test_lane_cumsum_rejects_bad_inputs():
    x = torch.zeros((4, 8), dtype=torch.int32)
    for bad, match in ((x.to(torch.int64), "dtype"),
                       (x.to(torch.float64), "dtype"),
                       (x[None], r"\[N\] or \[R,N\]"),
                       (torch.zeros(()), r"\[N\] or \[R,N\]"),
                       (x.t(), "contiguous"),
                       (x.to("meta"), "unsupported device")):
        with pytest.raises(ValueError, match=match):
            tscan.lane_cumsum(bad)


def test_float_tolerance_counts_the_kernels_additions():
    """80 additions at most inside a tile and into its neighbour's carry,
    one more per 8192-element tile of the row for the look-back chain."""
    u = 2.0 ** -24
    assert tscan.float_tolerance(1) == 81 * u
    assert tscan.float_tolerance(8192) == 81 * u
    assert tscan.float_tolerance(8193) == 82 * u
    assert tscan.float_tolerance(2 ** 20) == (80 + 128) * u
    assert tscan.float_tolerance(790_210) == (80 + 97) * u


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("exclusive", [False, True])
def test_lane_cumsum_cpu_never_touches_the_c_library(rng, monkeypatch,
                                                     dtype, exclusive):
    """On a CPU tensor the wrapper runs the plain version without looking
    up, building or launching K3."""
    def refuse(*args, **kw):
        raise AssertionError("the CPU path reached the C library")

    from contextgs_tpu_torch.ops import cuda_build
    for module, name in ((tscan, "c_function"), (tscan, "launch"),
                         (tscan, "scratch"), (cuda_build, "raw_stream"),
                         (cuda_build, "c_function"),
                         (cuda_build, "load_library"), (cuda_build, "build")):
        monkeypatch.setattr(module, name, refuse)
    x = rng.integers(0, 1000, (3, 5000)).astype(dtype)
    got = tscan.lane_cumsum(torch.from_numpy(x), exclusive=exclusive)
    want = np.cumsum(x, axis=1, dtype=dtype)
    if exclusive:
        want = want - x
    np.testing.assert_array_equal(got.numpy(), want)
