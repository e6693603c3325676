"""Host feed (the host-to-device copy): device ms of the trace's
host-to-device copies per dispatched batch (``_forward`` call)."""


def read(ctx):
    t, n = ctx["trace"], ctx["port"].get("forwards", 0)
    return None if t is None or not n or t.h2d_s <= 0 else 1e3 * t.h2d_s / n
