"""Host feed (infer/pipeline.py bucketing): useful windows over the rows
the harness counted entering ``InferencePipeline._forward``, in %."""


def read(ctx):
    rows = sum(ctx["port"].get("rows", []))
    return 100.0 * ctx["run"]["useful_windows"] / rows if rows else None
