"""The roofline and FLOP arithmetic against counts made by hand at a
tiny size."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench import roofline


def one_tile(opacity: float):
    """One 16x16 tile, one gaussian at its centre, wide enough that every
    pixel's alpha is opacity·exp(power) with power about 0."""
    rows = torch.tensor([[8.0, 8.0, 1e-6, 0.0, 1e-6, opacity, 1.0, 0.5,
                          0.25]])
    return rows, torch.zeros(1, dtype=torch.int32), torch.tensor(
        [0, 1], dtype=torch.int32)


class _Reading:
    def __init__(self, kept, kernels=(), shapes=()):
        self._kept, self._kernels, self._shapes = kept, kernels, shapes
        self._cache = {}

    def kept(self, key):
        return self._kept

    def kernels(self, part=""):
        return [k for k in self._kernels if part in k[0]]

    def shapes(self, key):
        return self._shapes

    def cached(self, key, compute):
        if key not in self._cache:
            self._cache[key] = compute()
        return self._cache[key]


def test_pairs_of_one_tile_by_hand():
    rows, ids, bounds = one_tile(0.5)
    r = _Reading([((rows, ids, bounds, 16, 16, 1e-4, 0), {})])
    (*_, pairs), = roofline.k1_calls(r)
    # every pixel of the tile tests T·(1-α) of its one instance and blends
    # it
    assert pairs["tested"] == pairs["blended"] == 256
    assert pairs["bwd_blended"] == 256
    assert roofline.needed_ops(pairs, roofline.NEED_K1) == 256 * (15 + 7)
    assert roofline.needed_ops(pairs, roofline.NEED_K2) == 256 * 61


def test_a_faint_gaussian_needs_no_operations():
    rows, ids, bounds = one_tile(1e-3)       # alpha under 1/255 everywhere
    r = _Reading([((rows, ids, bounds, 16, 16, 1e-4, 0), {})])
    (*_, pairs), = roofline.k1_calls(r)
    assert pairs["tested"] == 0 and pairs["bwd_blended"] == 0
    assert roofline.needed_ops(pairs, roofline.NEED_K1) == 0


def test_k1_and_k2_bounds_by_hand():
    rows, ids, bounds = one_tile(0.5)
    pairs = dict(tested=256, blended=256, bwd_blended=256)
    k1_bytes = 1 * 9 * 4 + 1 * 4 + 2 * 4 + 256 * 5 * 4
    k1 = max(k1_bytes / 3.35e12, 256 * 22 / 67e12,
             256 / (132 * 16 * 1.98e9)) * 1e3
    assert roofline.k1_bound_ms(rows, ids, bounds, 16, 16, pairs) == \
        pytest.approx(k1, rel=1e-12)
    k2_bytes = 1 * 9 * 4 + 1 * 4 + 2 * 4 + 256 * 9 * 4 + 9 * 4
    k2 = max(k2_bytes / 3.35e12, 256 * 61 / 67e12,
             256 / (132 * 16 * 1.98e9)) * 1e3
    assert roofline.k2_bound_ms(rows, ids, bounds, 16, 16, pairs) == \
        pytest.approx(k2, rel=1e-12)


def test_kernel_share_sums_bounds_over_device_time():
    rows, ids, bounds = one_tile(0.5)
    kept = [((rows, ids, bounds, 16, 16, 1e-4, 0), {})] * 2
    kernels = [("blend_forward_kernel", 0.0, 2.0),
               ("blend_forward_kernel", 10.0, 12.0)]
    r = _Reading(kept, kernels)
    (*args, pairs), _ = roofline.k1_calls(r)
    want = 100 * 2 * roofline.k1_bound_ms(*args, pairs) / (4.0 / 1e3)
    assert roofline.kernel_share(r, roofline.K1_KERNEL,
                                 roofline.k1_bound_ms) == pytest.approx(want)
    # a trace with another number of kernels than kept calls reads nothing
    assert roofline.kernel_share(_Reading(kept, kernels[:1]),
                                 roofline.K1_KERNEL,
                                 roofline.k1_bound_ms) is None


def test_linear_flops_by_hand():
    r = _Reading([], shapes=[[(10, 54), (50, 54), (50,)],
                             [(2, 3, 100), (133, 100), (133,)]])
    assert roofline.linear_flops(r) == 2 * 10 * 54 * 50 + 2 * 6 * 100 * 133
    assert math.isclose(roofline.bound_ms(3.35e12, 0, 0), 1e3)
