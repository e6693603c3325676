"""Training step (train/steps.py): device busy ms per step over the traced
window."""


def read(ctx):
    t, steps = ctx["trace"], ctx["run"].get("steps", 0)
    return None if t is None or not steps else 1e3 * t.busy_s / steps
