"""The port's multi-rank dryrun (``parallel/dryrun.py``, the twin of
``__graft_entry__.dryrun_multichip``): gloo CPU processes on a data ×
model mesh run the data-parallel train step, the head-parallel ensemble
forward, data-parallel serving and the head-parallel joint step."""

import sys

import pytest

from synthetic_audio_detection_tpu_torch.parallel import dryrun


def test_mesh_layout_scaling():
    sys.path.insert(0, ".")
    import __graft_entry__ as g

    for n, want in ((1, (1, 1)), (8, (4, 2)), (16, (4, 4)), (32, (8, 4))):
        assert dryrun._mesh_layout(n) == g._mesh_layout(n) == want


def test_dryrun_4_ranks_2x2_mesh():
    dryrun.dryrun_multichip(4, timeout=300)


def test_dryrun_reports_a_failing_rank(monkeypatch):
    """A rank that fails ends the dryrun with its stderr, not a hang."""
    monkeypatch.setattr(dryrun, "MODULE", "synthetic_audio_detection_tpu_torch.no_such_module")
    with pytest.raises(RuntimeError, match="ranks .* failed"):
        dryrun.dryrun_multichip(2, timeout=120)


@pytest.mark.slow
def test_dryrun_32_ranks_8x4_mesh():
    dryrun.dryrun_multichip(32, timeout=1800)
