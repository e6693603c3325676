"""Training feed (the program's ``train_step.feed`` range in
train/trainer.py:device_batches: the wait for the batcher, the padding,
the pinning and the copy): device idle ms inside the traced window while
the host was in it (idle gaps labelled by the innermost open span), per
step. Nothing where the program has no such range."""


def read(ctx):
    t, steps = ctx["trace"], ctx["run"].get("steps", 0)
    if t is None or not steps or "train_step.feed" not in t.span_device_s:
        return None
    return 1e3 * t.gap_by_host.get("train_step.feed", 0.0) / steps
