"""Synthetic Audio Detection — PyTorch/CUDA port of the serving path, the
submodel trainer, the ensemble-building path, the release path and the
data preparation.

A second package beside ``synthetic_audio_detection_tpu`` (the JAX
reference, which stays as it is). On one NVIDIA GPU it serves a merged
ResNet ensemble:

    cli/inference_runner.py → infer/pipeline.py:InferencePipeline
      → ops/cuda_melspec.py (the factored log-mel kernel, csrc/) or the
        plain PyTorch front end in ops/melspec.py
      → ensemble/multihead.py (shared, trunk-shared or dense ResNet
        backbones, batched MLP heads; the shared backbone's 3x3 convs
        optionally through ops/cuda_conv.py, the conv + BN + ReLU kernel
        in csrc/)
      → decision rule → reference JSON

and trains one binary sub-model:

    cli/submodel_trainer.py → train/trainer.py:Trainer
      → data/dataset.py (or data/grain_pipeline.py) → train/steps.py
        (the log-mel kernel in dB-only mode under bf16, SpecAugment and
        crop, the flax-BatchNorm ResNet on cuDNN, optax's AdamW)
      → checkpoints/serialization.py (native msgpack and the .pth twin)

and builds ensembles:

    cli/ensemble_trainer.py → train/joint.py:JointTrainer (N heads on one
      backbone pass, the same step machinery; the eval step on the train
      step's mel) → a resume file and the merged ensemble in both formats
    cli/add_head.py → train/add_head.py:HeadAdder (one new head on a
      merged artifact's frozen trunk, spliced in)
    cli/model_merger.py → ensemble/merger.py (sub-model checkpoints and a
      CSV recipe → a merged ensemble)

and releases one:

    tools/calibrate_ensemble.py → infer/study.py (the serving pipeline over
      a labeled tree) → utils/calibration.py (per-column temperatures, ECE,
      operating points) → the merged checkpoint's metadata
    tools/accuracy_study.py, robustness_study.py, decision_ab.py (held-out
      accuracy, AUC/EER, perturbations, decision rules)
    infer/export.py (a torch.export program of the serving forward, the
      weights once) → InferencePipeline.from_artifact → cli/serve.py
      --artifact; tools/artifact_drive.py holds it to the live pipelines

and prepares the data:

    tools/study_pipeline.py → the six ETL CLIs (cli/file_renamer,
      audio_convert, audio_augmenter, audio_segmenter, dataset_manager,
      file_manager), each in its own process → data/etl.py, data/augment.py,
      audio/dsp.py (NumPy and SciPy, no torch) → a train/test tree;
      audio/native.py binds the C++ audio library (native/sadio.cpp, built
      with g++ at first use); checkpoints/orbax_io.py is the trainer's
      step-indexed asynchronous checkpointer; utils/profiling.py traces

Every fresh model a trainer builds draws flax's default init
(models/init.py), as the reference's ``model.init`` does.

The port imports ``torch``, ``numpy`` and ``scipy``, never ``jax`` and
nothing of the reference package: it keeps its own copies of the host
modules it needs (``audio/decode``, ``audio/wavio``, ``audio/resample``,
``utils/config``, ``utils/calibration``, ``utils/metrics``,
``utils/tb_writer``, ``checkpoints/torch_compat``, ``train/plateau``,
``data/dataset``, ``audio/dsp``, ``data/etl``, ``data/augment``).
"""

from __future__ import annotations

__version__ = "0.1.0"
