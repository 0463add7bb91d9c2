"""ms a view: the window's seconds over the views rendered in it, one
closed-loop viewer."""


def read(r):
    return 1e3 * r.window.seconds / r.window.units
