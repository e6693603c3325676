"""The port's training ops and host modules against the JAX package, on the
CPU: SpecAugment, RandomResizedCrop and the waveform augmentation fed the
JAX package's own draws (from the same keys), the plateau scheduler, the
metrics, and the data path (list_samples with hard negatives, the
short-file policy, the batchers).

Tolerances: masks and the data path exactly; the crop 1e-5 absolute on
unit-scale images and the waveform augmentation 1e-6 absolute on
waveforms of scale 0.3 (float32 sums in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import parity_bounds
import pytest
import torch

from synthetic_audio_detection_tpu.data import dataset as JD
from synthetic_audio_detection_tpu.ops import image as JI
from synthetic_audio_detection_tpu.ops import masking as JM
from synthetic_audio_detection_tpu.ops import waveform_augment as JW
from synthetic_audio_detection_tpu.train.plateau import PlateauState as JPlateau
from synthetic_audio_detection_tpu.utils import metrics as JMet
from synthetic_audio_detection_tpu.utils.config import SpecAugmentConfig as JAug
from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.data import dataset as TD
from synthetic_audio_detection_tpu_torch.data import grain_pipeline as TG
from synthetic_audio_detection_tpu_torch.ops import image as TI
from synthetic_audio_detection_tpu_torch.ops import masking as TM
from synthetic_audio_detection_tpu_torch.ops import waveform_augment as TW
from synthetic_audio_detection_tpu_torch.train.plateau import PlateauState as TPlateau
from synthetic_audio_detection_tpu_torch.utils import metrics as TMet
from synthetic_audio_detection_tpu_torch.utils.config import SpecAugmentConfig as TAug


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU work, restored after: the
    suite runs several workers on one machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# SpecAugment, crop, waveform augmentation: the apply parts on JAX's draws
# ---------------------------------------------------------------------------

def _jax_axis_draw(key, batch, dim, param):
    """JAX masking._axis_mask's draws."""
    k1, k2 = jax.random.split(key)
    value = jax.random.uniform(k1, (batch, 1), minval=0.0, maxval=float(param))
    start = jax.random.uniform(k2, (batch, 1)) * (dim - value)
    return {"value": t(value), "start": t(start)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_apply_matches_jax(seed):
    spec = np.random.default_rng(seed).standard_normal((3, 128, 63)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JM.spec_augment(key, jnp.asarray(spec), 15, 35))
    kf, kt = jax.random.split(key)
    draws = {"freq": _jax_axis_draw(kf, 3, 128, 15), "time": _jax_axis_draw(kt, 3, 63, 35)}
    got = TM.spec_augment_apply(t(spec), draws).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any()


def test_spec_augment_draw_follows_its_generator():
    spec = torch.randn(4, 128, 63)
    a = TM.spec_augment(torch.Generator().manual_seed(3), spec)
    b = TM.spec_augment(torch.Generator().manual_seed(3), spec)
    c = TM.spec_augment(torch.Generator().manual_seed(4), spec)
    assert torch.equal(a, b) and not torch.equal(a, c)
    d = TM.spec_augment_draw(torch.Generator().manual_seed(0), 1000, 128, 63)
    for axis, dim, param in (("freq", 128, 15), ("time", 63, 35)):
        v, s = d[axis]["value"], d[axis]["start"]
        assert float(v.min()) >= 0 and float(v.max()) < param
        assert float(s.min()) >= 0 and bool((s + v <= dim).all())


def _jax_crop_box(key, B, H, W, scale=(0.8, 1.0), ratio=(3 / 4, 4 / 3)):
    """JAX image.random_resized_crop's draws."""
    k_area, k_ratio, k_i, k_j = jax.random.split(key, 4)
    area = H * W * jax.random.uniform(k_area, (B,), minval=scale[0], maxval=scale[1])
    log_r = jax.random.uniform(k_ratio, (B,), minval=math.log(ratio[0]),
                               maxval=math.log(ratio[1]))
    aspect = jnp.exp(log_r)
    w = jnp.clip(jnp.sqrt(area * aspect), 1.0, float(W))
    h = jnp.clip(jnp.sqrt(area / aspect), 1.0, float(H))
    i = jax.random.uniform(k_i, (B,)) * (H - h)
    j = jax.random.uniform(k_j, (B,)) * (W - w)
    return {"i": t(i), "j": t(j), "h": t(h), "w": t(w)}


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 128, 251)])
def test_random_resized_crop_apply_matches_jax(shape):
    img = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JI.random_resized_crop(key, jnp.asarray(img)))
    got = TI.random_resized_crop_apply(t(img), _jax_crop_box(key, *shape)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_random_resized_crop_draw_stays_inside():
    box = TI.random_resized_crop_draw(torch.Generator().manual_seed(0), 500, 64, 80)
    area = box["h"] * box["w"] / (64 * 80)
    assert float(area.max()) <= 1.0 + 1e-6  # below 0.8 only where the clamp cut the box
    assert bool((area[(box["h"] < 64) & (box["w"] < 80)] >= 0.8 - 1e-5).all())
    assert bool((box["i"] >= 0).all() and (box["i"] + box["h"] <= 64 + 1e-4).all())
    assert bool((box["j"] >= 0).all() and (box["j"] + box["w"] <= 80 + 1e-4).all())


def _jax_wave_draws(key, b, n, cfg):
    """JAX waveform_augment.augment_waveforms's draws."""
    k_cut, k_lpm, k_snr, k_nm, k_noise = jax.random.split(key, 5)
    return {"cutoff_hz": t(jax.random.uniform(k_cut, (b,), minval=cfg.wave_lowpass_hz[0],
                                              maxval=cfg.wave_lowpass_hz[1])),
            "lowpass": t(jax.random.bernoulli(k_lpm, cfg.wave_lowpass_prob, (b,))),
            "snr_db": t(jax.random.uniform(k_snr, (b,), minval=cfg.wave_snr_db[0],
                                           maxval=cfg.wave_snr_db[1])),
            "noise_on": t(jax.random.bernoulli(k_nm, cfg.wave_noise_prob, (b,))),
            "noise": t(jax.random.normal(k_noise, (b, n)))}


def test_waveform_augment_apply_matches_jax():
    fields = dict(wave_noise_prob=0.5, wave_lowpass_prob=0.5)
    wav = (np.random.default_rng(2).standard_normal((6, 4000)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(JW.augment_waveforms(key, jnp.asarray(wav), JAug(**fields), 32_000))
    draws = _jax_wave_draws(key, 6, 4000, JAug(**fields))
    assert draws["lowpass"].any() and (~draws["lowpass"]).any()
    got = TW.augment_apply(t(wav), draws, TAug(**fields), 32_000).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_lowpass_kernels_match_jax():
    """Both packages' float32 kernels against their float64 evaluation,
    within parity_bounds.lowpass_truth's float32 bound (a few ulps of
    each tap: the order of the normalizing sum, the sine's argument)."""
    cut = np.array([4000.0, 9000.0, 15000.0], np.float32)
    want, bound = parity_bounds.lowpass_truth(cut, 63, 32_000)
    parity_bounds.assert_within(TW.lowpass_kernels(t(cut), 63, 32_000).numpy(), want, bound,
                                "port")
    parity_bounds.assert_within(np.asarray(JW.lowpass_kernels(jnp.asarray(cut), 63, 32_000)),
                                want, bound, "reference")


def test_lowpass_bound_rejects_a_one_sample_shift():
    """The Hann window one tap off its centre (hann(n − 1)): the float64
    bound rejects it, as the fixed 1e-7 against JAX did."""
    cut = np.array([4000.0, 9000.0, 15000.0], np.float32)
    want, bound = parity_bounds.lowpass_truth(cut, 63, 32_000)
    fc = t(cut / 32_000)[:, None]
    n = torch.arange(63, dtype=torch.float32) - 31.0
    win = 0.5 - 0.5 * torch.cos(2.0 * torch.pi * (torch.arange(63) - 1) / 62)
    h = 2.0 * fc * torch.sinc(2.0 * fc * n) * win.float()
    shifted = (h / torch.sum(h, dim=1, keepdim=True)).numpy()
    with pytest.raises(AssertionError):
        parity_bounds.assert_within(shifted, want, bound)
    ref = np.asarray(JW.lowpass_kernels(jnp.asarray(cut), 63, 32_000))
    assert np.abs(shifted - ref).max() > 1e-7


def test_waveform_augment_draw_follows_its_generator():
    cfg = TAug(wave_noise_prob=0.5, wave_lowpass_prob=0.25)
    wav = torch.randn(4, 2000) * 0.2
    a = TW.augment_waveforms(torch.Generator().manual_seed(1), wav, cfg, 32_000)
    b = TW.augment_waveforms(torch.Generator().manual_seed(1), wav, cfg, 32_000)
    assert torch.equal(a, b)
    assert TW.augment_draw(None, 4, 10, TAug()) == {}  # off: no draw, no change


# ---------------------------------------------------------------------------
# Plateau and metrics
# ---------------------------------------------------------------------------

def test_plateau_matches_reference_and_torch():
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1.0)
    sch = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, mode="min", factor=0.5, patience=2)
    port, ref = TPlateau(), JPlateau()
    vals = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.55, 0.56, 0.57, 0.58]
    vals += list(np.random.default_rng(0).uniform(0.4, 0.6, 20))
    for v in vals:
        sch.step(float(v))
        assert port.update(float(v)) == ref.update(float(v)) == pytest.approx(
            opt.param_groups[0]["lr"])
        assert port.state_dict() == ref.state_dict()
    sd = sch.state_dict()
    got = TPlateau.from_torch_state_dict(sd, base_lr=1.0)
    assert got.state_dict() == JPlateau.from_torch_state_dict(sd, base_lr=1.0).state_dict()
    assert got.scale == pytest.approx(opt.param_groups[0]["lr"])
    fresh = torch.optim.lr_scheduler.ReduceLROnPlateau(opt).state_dict()
    assert TPlateau.from_torch_state_dict(fresh).best is None
    assert TPlateau.from_state_dict(port.state_dict()) == port


def test_metrics_match_reference():
    rng = np.random.default_rng(3)
    conf = rng.integers(0, 20, (3, 3)).astype(np.float64)
    names = ["Real", "SynA", "SynB"]
    assert TMet.report_from_confusion(conf, names) == JMet.report_from_confusion(conf, names)
    rep = TMet.report_from_confusion(conf, names)
    assert TMet.format_report(rep) == JMet.format_report(rep)
    assert TMet.format_confusion(conf, names) == JMet.format_confusion(conf, names)
    scores = np.round(rng.uniform(size=200), 2)  # ties on purpose
    labels = rng.integers(0, 2, 200)
    assert TMet.roc_auc(scores, labels) == JMet.roc_auc(scores, labels)
    assert TMet.equal_error_rate(scores, labels) == JMet.equal_error_rate(scores, labels)
    for a, b in zip(TMet.binary_roc(scores, labels), JMet.binary_roc(scores, labels)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Data path
# ---------------------------------------------------------------------------

def _write(path, seconds, sr=32_000, seed=0):
    x = (np.random.default_rng(seed).standard_normal(int(seconds * sr)) * 0.2)
    wavio.write_wav(path, np.clip(x, -1, 1).astype(np.float32), sr)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    for split in ("train", "test"):
        for c, cls in enumerate(("Real", "SynA", "SynB")):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(3):
                _write(str(d / f"{cls}_{i}.wav"), 8.2 - i * 2.3, seed=10 * c + i)
    _write(str(root / "train" / "Real" / "short.wav"), 1.0)
    _write(str(root / "train" / "SynA" / "at44k.wav"), 5.0, sr=44_100)
    (root / "train" / "Real" / "notes.txt").write_text("not audio")
    return str(root)


@pytest.mark.parametrize("extra", [(), ("SynB",)])
def test_list_samples_matches_reference(tree, extra):
    got = TD.list_samples(tree, "train", ["Real", "SynA"], extra_negative_classes=extra)
    assert got == JD.list_samples(tree, "train", ["Real", "SynA"],
                                  extra_negative_classes=extra)
    assert sum(1 for _, label in got if label == 0) == 4 + 3 * len(extra)
    with pytest.raises(FileNotFoundError):
        TD.list_samples(tree, "train", ["Real", "Missing"])


def test_short_file_policy_matches_reference(tree):
    """Two segments, one duplicated, zero-padded and duplicated, dropped, and
    a 44.1 kHz file resampled first."""
    kinds = set()
    for path, _ in TD.list_samples(tree, "train", ["Real", "SynA", "SynB"]):
        got, want = TD.load_two_segments(path), JD.load_two_segments(path)
        if want is None:
            assert got is None
            kinds.add("dropped")
            continue
        assert got.shape == want.shape == (2, TD.SEGMENT_SAMPLES)
        np.testing.assert_array_equal(got, want)
        kinds.add("same" if np.array_equal(got[0], got[1]) else "two")
    assert kinds == {"dropped", "same", "two"}


def test_batchers_match_reference(tree):
    samples = TD.list_samples(tree, "train", ["Real", "SynA"], ("SynB",))
    assert TD.derive_epoch_seed(42, 3) == JD.derive_epoch_seed(42, 3)
    port = list(TD.WaveformBatcher(samples, 3, workers=2, seed=7).epoch(1))
    ref = list(JD.WaveformBatcher(samples, 3, workers=2, seed=7).epoch(1))
    assert len(port) == len(ref) >= 3
    for p, r in zip(port, ref):
        for k in ("audio", "label"):
            np.testing.assert_array_equal(p[k], r[k])
    padded, n = TD.pad_batch(port[-1], 6)
    ref_padded, ref_n = JD.pad_batch(ref[-1], 6)
    assert n == ref_n and padded["audio"].shape[0] == 6
    np.testing.assert_array_equal(padded["audio"], ref_padded["audio"])


def test_worker_loader_gives_the_threads_backends_batches(tree):
    """--data-backend grain: a DataLoader with worker processes, the same
    files per batch as the threads backend's order rule for one seed; a
    dropped file's rows zero and weighted 0; the last partial batch
    dropped."""
    samples = TD.list_samples(tree, "train", ["Real", "SynA"], ("SynB",))
    threads = list(TD.WaveformBatcher(samples, 4, workers=1, seed=5).epoch(2))
    loader = list(TG.make_loader(samples, 4, seed=5, epoch_idx=2, workers=2))
    order = TG.epoch_order(samples, 5, 2)
    assert len(loader) == len(samples) // 4
    for b, batch in enumerate(loader):
        assert batch["audio"].shape == (8, TD.SEGMENT_SAMPLES)
        files = order[4 * b:4 * b + 4]
        kept = np.repeat([TD.load_two_segments(p) is not None for p, _ in files], 2)
        np.testing.assert_array_equal(batch["weight"], kept.astype(np.float32))
        np.testing.assert_array_equal(batch["audio"][kept], threads[b]["audio"])
        np.testing.assert_array_equal(batch["label"][kept], threads[b]["label"])
        assert not batch["audio"][~kept].any()
