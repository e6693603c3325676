"""The plain float32 reference: the log-mel front end, ResNet-18 with eval
or train-mode BatchNorm, the binary heads, the ensemble's aggregate and
decision, window slicing, and the phase-2 train step.

Plain PyTorch and NumPy, written from the published descriptions. It
imports nothing of the port or of the JAX package and takes nothing the
port made: it draws the weights again from the seed (``weights``) and
works out every feature, table and state from the inputs the benchmark
generated. Float32 matmuls and convolutions run with TF32 off
(``exact``); ``quantizer`` rounds the operands of every convolution and
linear layer to a lower precision for the control.
"""

from __future__ import annotations

import importlib


def backbone(model):
    """The reference module of the configuration's backbone, found by its
    ``block``: ``portbench/reference/resnet_<block>.py``, with ``shapes``
    and ``forward``. A new block adds a module; a block without one is
    refused, never run as another."""
    name = model["block"]
    module = f"portbench.reference.resnet_{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no reference for a {name!r} block: portbench/reference/"
                         f"resnet_{name}.py is missing") from None
