"""Seconds a decode in the codec's CDF build (`compression/codec._cdf_rows`,
host float64), by the host clock around each call."""

HOST_SPANS = {"cdf": ("contextgs_tpu_torch.compression.codec", "_cdf_rows")}


def read(r):
    return r.host_s("cdf") / r.units if r.units else None
