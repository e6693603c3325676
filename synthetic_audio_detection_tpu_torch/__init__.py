"""Synthetic Audio Detection — PyTorch/CUDA port of the serving path.

A second package beside ``synthetic_audio_detection_tpu`` (the JAX
reference, which stays as it is). It serves a merged ResNet ensemble on one
NVIDIA GPU:

    cli/inference_runner.py → infer/pipeline.py:InferencePipeline
      → ops/cuda_melspec.py (the factored log-mel kernel, csrc/) or the
        plain PyTorch front end in ops/melspec.py
      → ensemble/multihead.py (shared or dense ResNet backbones, batched
        MLP heads; the shared backbone's 3x3 convs optionally through
        ops/cuda_conv.py, the conv + BN + ReLU kernel in csrc/)
      → decision rule → reference JSON

The port imports ``torch``, ``numpy`` and ``scipy``, never ``jax`` and
nothing of the reference package: it keeps its own copies of the host
modules it needs (``audio/decode``, ``audio/wavio``, ``utils/config``,
``utils/calibration``, ``checkpoints/torch_compat``).
"""

from __future__ import annotations

__version__ = "0.1.0"
