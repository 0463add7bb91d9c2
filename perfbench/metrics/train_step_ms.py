"""ms a training step: the window's seconds over the steps completed in it."""


def read(r):
    return 1e3 * r.window.seconds / r.window.units
