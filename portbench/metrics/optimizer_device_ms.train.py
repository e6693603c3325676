"""Optimizer (the program's ``train_step.optimizer`` range): device ms of
the kernels launched inside it, per step."""


def read(ctx):
    t, steps = ctx["trace"], ctx["run"].get("steps", 0)
    dev = 0.0 if t is None else t.span_device_s.get("train_step.optimizer", 0.0)
    return None if dev <= 0 or not steps else 1e3 * dev / steps
