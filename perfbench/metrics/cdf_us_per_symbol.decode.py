"""µs of the program's `codec/cdf` spans (the host's CDF rows of each
stream chunk) a coded symbol: their host time over the `symbols` counter
(`perfbench/spans.py`)."""

from perfbench import spans


def read(r):
    cdf = spans.per_unit(r, "host_ms", "codec/cdf", scale=1e3)
    symbols = spans.per_unit(r, "counters", "symbols")
    return cdf / symbols if cdf is not None and symbols else None
