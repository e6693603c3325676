"""Training step (the program's ``train_step.backward`` range around
``gradients`` in train/steps.py; autograd's device thread launches the
backward while it is open): device idle ms inside the traced window while
the host was in it (idle gaps labelled by the innermost open span), per
step: the backward's launch gaps. Nothing where the program has no such
range."""


def read(ctx):
    t, steps = ctx["trace"], ctx["run"].get("steps", 0)
    if t is None or not steps or "train_step.backward" not in t.span_device_s:
        return None
    return 1e3 * t.gap_by_host.get("train_step.backward", 0.0) / steps
