"""Synthetic Audio Detection — PyTorch/CUDA port of the serving path.

A second package beside ``synthetic_audio_detection_tpu`` (the JAX
reference, which stays as it is). It serves a merged ResNet ensemble on one
NVIDIA GPU:

    cli/inference_runner.py → infer/pipeline.py:InferencePipeline
      → ops/cuda_melspec.py (the factored log-mel kernel, csrc/) or the
        plain PyTorch front end in ops/melspec.py
      → ensemble/multihead.py (shared or dense ResNet backbones, batched
        MLP heads) → decision rule → reference JSON

The port imports ``torch``, ``numpy`` and ``scipy`` and never ``jax``. It
reuses the reference package's jax-free host modules (``audio/decode``,
``audio/wavio``, ``utils/config``, ``utils/calibration``,
``checkpoints/torch_compat``), which ``synthetic_audio_detection_tpu``'s lazy
``__init__`` lets it import without pulling in JAX.
"""

from __future__ import annotations

__version__ = "0.1.0"
