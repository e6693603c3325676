"""Whole serving forward: the frozen model FLOP of the useful windows (the
log-mel's DFT and mel product, the backbone at the input size times the
backbones run, the heads; portbench/work/model.py) over the wall time of
the window, as a share of the bf16 peak (989 TFLOP/s), in %. Read from
the window that the traced run first runs untraced (the profiler slows
the host), so it is the rate that ``windows_per_s`` measures."""

from portbench.work import model, peaks

WINDOW = "untraced"


def read(ctx):
    run = ctx.get("untraced")
    if run is None or not run.get("useful_windows"):
        return None
    flops = run["useful_windows"] * model.serve_ops_per_window(ctx["cfg"])
    return 100.0 * flops / run["window_s"] / peaks.PEAK_BF16
