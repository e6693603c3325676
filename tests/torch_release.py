"""Shared inputs of the release-path tests (test_torch_calibration.py,
test_torch_study.py, test_torch_study_tools.py, test_torch_export.py):
seeded ResNet-18 ensembles carried into both packages, and a tiny
labeled tree of 4-s tone clips."""

import jax
import numpy as np

from synthetic_audio_detection_tpu.audio import wavio
from synthetic_audio_detection_tpu.ensemble import multihead as JE
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier as JaxClassifier
from synthetic_audio_detection_tpu_torch.checkpoints import from_jax
from tests.test_torch_streaming import jax_variables

SR = 32_000
NAMES = ["SynA", "SynB", "Real"]


def ensembles(names=NAMES, generic=False, calibration=None, shared=False):
    """(the JAX package's ensemble, the port's) on the same seeded weights:
    one head per synthetic class (and the generic head), 64² inputs."""
    heads = len(names) - 1 + int(generic)
    vs = jax_variables(heads)
    if shared:
        vs = [{c: {**v[c], "base": vs[0][c]["base"]} for c in v} for v in vs]
    je = JE.build_ensemble(JaxClassifier(backbone="resnet18"), vs, names,
                           detect_shared_backbone=shared, generic_head=generic)
    je.calibration = calibration
    te = from_jax.ensemble_from_variables(jax.tree_util.tree_map(np.asarray, je.variables),
                                          names, generic_head=generic,
                                          detect_shared_backbone=shared,
                                          calibration=calibration)
    return je, te


def tiny_tree(root, extra=("SynZ",), seconds=4):
    """<root>/<Class>/*.wav: tone clips (and noise) per class, as
    tests/test_study.py writes them, plus folders that name no class of
    the ensemble (``extra``)."""
    rng = np.random.default_rng(0)
    t = np.arange(seconds * SR) / SR
    spec = [("Real", [220.0, 330.0]), ("SynA", [1000.0, 1500.0]), ("SynB", [3000.0, 600.0])]
    spec += [(c, [5000.0]) for c in extra]
    for cls, freqs in spec:
        d = root / cls
        d.mkdir(parents=True)
        for i, f in enumerate(freqs):
            x = (0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(t.size))
            wavio.write_wav(str(d / f"{i:016x}_Segment_000.wav"), x.astype(np.float32), SR)
        (d / "notes.txt").write_text("not audio")
    return str(root)
