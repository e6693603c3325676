"""The port's calibration (utils/calibration.py) against the JAX package's on
the same seeded numpy logits: both are float64 numpy on the host, so the
fitted temperatures, the ECE and NLL figures and every operating point
agree to 1e-12 (they come out equal); and the port's pipeline engages a
calibration as the JAX package's does (the stored threshold's precedence,
per-column thresholds, the generic column)."""

import functools

import numpy as np
import pytest

from synthetic_audio_detection_tpu.infer import pipeline as JP
from synthetic_audio_detection_tpu.utils import calibration as JCal
from synthetic_audio_detection_tpu.utils.config import InferenceConfig, SpectrogramConfig
from synthetic_audio_detection_tpu_torch.infer import pipeline as TP
from synthetic_audio_detection_tpu_torch.utils import calibration as TCal
from tests.torch_release import ensembles

TOL = 1e-12
SPEC = SpectrogramConfig.inference(out_size=64)


def _logits(n=240, cols=4, seed=0, scale=(0.5, 3.0, 1.0, 6.0)):
    """Seeded logits of ``cols`` columns with some signal for the classes
    and a column scale each, over/under-confident alike; class_idx in
    [0, cols - 1 - generic] drawn with every class present."""
    rng = np.random.default_rng(seed)
    return rng, rng.standard_normal((n, cols)) * np.resize(np.asarray(scale), cols)


def _case(n_named, generic, seed=0, n=240):
    cols = n_named + 1 + int(generic)
    rng, z = _logits(n, cols, seed)
    ci = rng.integers(0, n_named + 1, n)
    for j in range(n_named):  # each specialist column leans to its class
        z[:, j] += 2.5 * (ci == j) - 1.0
    if generic:
        z[:, n_named] += 2.0 * (ci != n_named) - 1.0
    z[:, -1] += 3.0 * (ci == n_named) - 1.5
    return z.astype(np.float32), ci, [f"Syn{c}" for c in "ABCDE"[:n_named]] + ["Real"]


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, str) or a is None:
        assert a == b
    else:
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (a, b)


@pytest.mark.parametrize("case", ["mixed", "separable", "single_class", "zeros", "flat", "empty"])
def test_fit_temperature_matches_reference(case):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, 300).astype(np.float64)
    z = {"mixed": rng.standard_normal(300) * 4 + (2 * y - 1),
         "separable": 3 * (2 * y - 1) + 0.1 * rng.standard_normal(300),
         "single_class": rng.standard_normal(300),
         "zeros": np.zeros(300),
         "flat": 1e-3 * rng.standard_normal(300) - 0.5 * (2 * y - 1),
         "empty": np.zeros(0)}[case]
    if case == "single_class":
        y = np.ones(300)
    if case == "empty":
        y = np.zeros(0)
    got, want = TCal.fit_temperature(z, y), JCal.fit_temperature(z, y)
    assert abs(got - want) <= TOL * max(1.0, want)
    for s in (1.0, 0.3, 1.0 / got):
        assert abs(TCal.binary_nll(z, y, s) - JCal.binary_nll(z, y, s)) <= TOL if z.size else True
    with pytest.raises(ValueError):
        TCal.fit_temperature(np.zeros(3), np.zeros(4))


@pytest.mark.parametrize("n_bins", [15, 7])
def test_ece_and_sigmoid_match_reference(n_bins):
    rng = np.random.default_rng(2)
    u = np.concatenate([rng.standard_normal(500) * 5, [-800.0, 800.0, 0.0]])
    np.testing.assert_array_equal(TCal.stable_sigmoid(u), JCal.stable_sigmoid(u))
    p = TCal.stable_sigmoid(u)
    p[:3] = [0.0, 1.0, 1.0]
    y = (rng.random(p.size) < p).astype(np.float64)
    got = TCal.expected_calibration_error(p, y, n_bins)
    assert abs(got - JCal.expected_calibration_error(p, y, n_bins)) <= TOL
    assert TCal.expected_calibration_error(np.zeros(0), np.zeros(0)) == 0.0
    with pytest.raises(ValueError):
        TCal.expected_calibration_error(p, y[:-1])


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("method", ["eer", "sidak"])
@pytest.mark.parametrize("store_eer", [False, True])
def test_fit_ensemble_calibration_matches_reference(generic, method, store_eer):
    z, ci, names = _case(3, generic, seed=3)
    kw = dict(store_eer_threshold=store_eer, store_column_thresholds=True,
              column_threshold_method=method, sidak_alpha=0.1, fit_on="fit (240 windows)",
              generic_head=generic)
    got = TCal.fit_ensemble_calibration(z, ci, names, **kw)
    want = JCal.fit_ensemble_calibration(z, ci, names, **kw)
    _equal(got, want)
    assert len(got["temperatures"]) == len(names) + int(generic)
    if generic:
        assert got["column_names"] == names[:-1] + ["__generic__", "Real"]


def test_fit_ensemble_calibration_edge_cases_match_reference():
    """Columns without positives fall back to 0.5, no real windows leave
    the Šidák points at 0.5, and the two packages raise alike."""
    z, ci, names = _case(2, True, seed=4, n=60)
    no_real = ci != 2
    for kw in (dict(store_column_thresholds=True),
               dict(store_column_thresholds=True, column_threshold_method="sidak"),
               dict(store_eer_threshold=True)):
        for rows in (no_real, ci != 0):
            _equal(TCal.fit_ensemble_calibration(z[rows], ci[rows], names, generic_head=True,
                                                 **kw),
                   JCal.fit_ensemble_calibration(z[rows], ci[rows], names, generic_head=True,
                                                 **kw))
    for bad in (dict(logits=z[:, :-1]), dict(class_idx=ci[:-1]),
                dict(store_column_thresholds=True, column_threshold_method="nope"),
                dict(store_column_thresholds=True, column_threshold_method="sidak",
                     sidak_alpha=1.0)):
        args = {**dict(logits=z, class_idx=ci, class_names=names, generic_head=True), **bad}
        with pytest.raises(ValueError):
            TCal.fit_ensemble_calibration(**args)
        with pytest.raises(ValueError):
            JCal.fit_ensemble_calibration(**args)


def test_column_target_is_the_fits_target():
    """The held-out ECE of tools/calibrate_ensemble.py scores each column
    against the target the fit used."""
    ci = np.array([0, 1, 2, 2, 1, 0])
    assert TCal.column_target(ci, 0, 2).tolist() == [1, 0, 0, 0, 0, 1]
    assert TCal.column_target(ci, 2, 2).tolist() == [0, 0, 1, 1, 0, 0]
    assert TCal.column_target(ci, 2, 2, generic_head=True).tolist() == [1, 1, 0, 0, 1, 1]
    assert TCal.column_target(ci, 3, 2, generic_head=True).tolist() == [0, 0, 1, 1, 0, 0]


@functools.lru_cache(maxsize=None)
def _models(generic):
    return ensembles(generic=generic)


CAL_GENERIC = {"temperatures": [1.2, 0.7, 2.0, 0.9], "threshold": 0.4,
               "column_thresholds": [0.35, 0.6, 0.2, 0.55]}
CAL_PLAIN = {"temperatures": [1.2, 0.7, 0.9], "column_thresholds": [0.35, 0.6, 0.55]}


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("threshold", [0.5, 0.6])
@pytest.mark.parametrize("per_column", [False, True])
@pytest.mark.parametrize("apply", [True, False])
def test_pipeline_engages_calibration_as_reference(generic, threshold, per_column, apply):
    """The stored threshold wins only over the 0.5 default, per-column
    thresholds replace it, --no-calibration turns both off; and the
    verdicts on the same logits are the reference's."""
    cal = CAL_GENERIC if generic else CAL_PLAIN
    je, te = _models(generic)
    je.calibration = te.calibration = cal
    infer = InferenceConfig(batch_size=8, threshold=threshold, apply_calibration=apply,
                            per_column_thresholds=per_column, generic_verdict=generic)
    if per_column and not apply:
        for make in (lambda: JP.InferencePipeline(je, spec=SPEC, infer=infer, use_pallas=False),
                     lambda: TP.InferencePipeline(te, spec=SPEC, infer=infer, device="cpu")):
            with pytest.raises(ValueError, match="per_column_thresholds"):
                make()
        return
    jp = JP.InferencePipeline(je, spec=SPEC, infer=infer, use_pallas=False)
    tp = TP.InferencePipeline(te, spec=SPEC, infer=infer, device="cpu")
    assert tp._cal == jp._cal and tp._threshold == jp._threshold
    np.testing.assert_array_equal(tp._col_thr, jp._col_thr)
    np.testing.assert_array_equal(tp._col_thr_vis, jp._col_thr_vis)
    assert tp._thr_generic == jp._thr_generic
    logits = (np.random.default_rng(5).standard_normal((11, te.num_heads + 1)) * 2
              ).astype(np.float32)
    windows = np.zeros((11, 128_000), np.float32)
    stamps = [(4.0 * i, 4.0 * i + 4.0) for i in range(11)]
    assert tp.analyze_windows(windows, stamps, logits=logits) == \
        jp.analyze_windows(windows, stamps, logits=logits)
