"""The device's idle share of the traced window, in %: one less the union
of the device operations' intervals over the window's length."""


def read(r):
    if r.window_us is None or not r.device_ops:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.window_s)
