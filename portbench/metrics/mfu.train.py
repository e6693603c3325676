"""Whole train step: the frozen FLOP of the phase-2 step's rows (the
forward of every stage, the backward through stages 3 and 4 and the head;
portbench/work/model.py) over the wall time of the window, as a share of
the bf16 peak (989 TFLOP/s), in %. Read from the window that the traced
run first runs untraced (the profiler slows the host's launches), so it
is the rate that ``train_rows_per_s`` measures."""

from portbench.work import model, peaks

WINDOW = "untraced"


def read(ctx):
    run = ctx.get("untraced")
    if run is None or not run.get("rows"):
        return None
    flops = run["rows"] * model.train_ops_per_row(ctx["cfg"], ctx["cfg"]["train"]["stop_grad_stage"])
    return 100.0 * flops / run["window_s"] / peaks.PEAK_BF16
