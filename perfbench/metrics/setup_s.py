"""Seconds of set-up: from the process's start to the first timed unit
(imports, inputs, the kernels' builds, the program's set-up and warm-up)."""


def read(r):
    return r.window.setup_s
