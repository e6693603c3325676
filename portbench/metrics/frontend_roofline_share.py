"""Front end (ops/cuda_melspec.py K1 and ops/melspec.finalize_features):
the frozen bound of every forward's front end (portbench/work/frontend.py,
data-sheet peaks) over the device time launched inside the harness's
``frontend`` spans, in %."""

from portbench.work import frontend, model


def read(ctx):
    t, rows = ctx["trace"], ctx["port"].get("rows", [])
    dev = 0.0 if t is None else t.span_device_s.get("portbench.frontend", 0.0)
    if dev <= 0 or not rows:
        return None
    cfg = ctx["cfg"]
    T, sr = model.window_samples(cfg), cfg["audio"]["sample_rate"]
    bound = sum(frontend.frontend_work(cfg["spectrogram"], sr, r, T).bound()[0] for r in rows)
    return 100.0 * bound / dev
