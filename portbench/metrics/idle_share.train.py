"""Device: 1 − the union of device activity over the traced window, in %."""


def read(ctx):
    t = ctx["trace"]
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
