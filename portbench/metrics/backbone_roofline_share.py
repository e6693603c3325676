"""Backbone and heads (ensemble/multihead.py → the fast backbone with the
conv kernel, or the plain ResNets on cuDNN): the frozen bound of every
conv, pool, residual and head of the backbones the configuration runs
(portbench/work/model.py, by the configuration's block) over the device
time launched inside the harness's ``backbone`` spans, in %."""

from portbench.work import model


def read(ctx):
    t, rows = ctx["trace"], ctx["port"].get("rows", [])
    dev = 0.0 if t is None else t.span_device_s.get("portbench.backbone", 0.0)
    if dev <= 0 or not rows:
        return None
    cfg = ctx["cfg"]
    bound = sum((model.backbone_work(cfg, r) * model.backbones_run(cfg)
                 + model.heads_work(cfg, r)).bound()[0] for r in rows)
    return 100.0 * bound / dev
