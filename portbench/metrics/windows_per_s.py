"""Useful (non-padding) windows that got a verdict, over the window's
whole wall time (until the last request completed). Host clock."""


def read(ctx):
    run = ctx["run"]
    return run["useful_windows"] / run["window_s"] if "useful_windows" in run else None
