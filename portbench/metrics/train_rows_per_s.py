"""Rows stepped over the window's whole wall time, the device synchronized
at its end. Host clock."""


def read(ctx):
    run = ctx["run"]
    return run["rows"] / run["window_s"] if "rows" in run else None
