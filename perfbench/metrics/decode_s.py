"""Seconds a scene decode: the window's seconds over the whole
`decode_scene` calls completed in it (the window ends at a decode's end)."""


def read(r):
    return r.window.seconds / r.window.units
