"""Seconds a decode in the range coder (`compression/coder.decode` and
`decode_shared`, host C++), by the host clock around each call."""

CODER = "contextgs_tpu_torch.compression.coder"
HOST_SPANS = {"coder": [(CODER, "decode"), (CODER, "decode_shared")]}


def read(r):
    return r.host_s("coder") / r.units if r.units else None
