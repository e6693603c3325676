"""The port's benchmark: cells of the PyTorch and CUDA package on one H100,
driven by the data files under this directory (``BENCHMARK.json`` at the
repository root lists them). Run a cell with

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Nothing here imports JAX or the JAX package; ``portbench.guard`` checks it.
"""
