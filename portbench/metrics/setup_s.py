"""Set-up seconds: from the process's start to the first timed request
(imports, CUDA context, the kernels' build or load, pools, weights, the
warm-up of the cell's shapes). Host clock."""


def read(ctx):
    return ctx["setup_s"]
