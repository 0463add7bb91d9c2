"""Start patterns of the segmented carry's tests (`models/levels.
segmented_carry`), shared by the CPU test against JAX and the card tests of
the kernel (`ops/carry.py`)."""

import numpy as np

TILE = 8192          # keys a tile of the kernel (`ops/carry.BLOCK`)
PATTERNS = ("every", "only_first", "first_not_start", "one_percent", "half")


def starts(pattern: str, n: int, rng) -> np.ndarray:
    """[n] bool: every key a start, key 0 alone, 1% with key 0 not a start,
    1%, or half of the keys (key 0 drawn like the rest)."""
    if pattern == "every":
        return np.ones(n, bool)
    if pattern == "only_first":
        out = np.zeros(n, bool)
        out[0] = True
        return out
    out = rng.random(n) < (0.5 if pattern == "half" else 0.01)
    if pattern == "first_not_start":
        out[0] = False
    return out


def long_run(n: int, rng) -> np.ndarray:
    """[n] bool, n ≥ 12 tiles: 1% starts in the first two tiles and the
    last one, none in between (a start-free run of at least 9 tiles, as the
    sentinel group of a densify grouping)."""
    assert n >= 12 * TILE
    out = rng.random(n) < 0.01
    out[2 * TILE:n - TILE] = False
    return out


def values(n: int, dtype, rng) -> np.ndarray:
    """[n] of `dtype` over its whole range, so that a wrong gather shows."""
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype,
                        endpoint=True)
