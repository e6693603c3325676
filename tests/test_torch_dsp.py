"""The port's ``audio/dsp.py`` against the JAX package's: both are NumPy on
the same inputs, so every function is held bit for bit."""

import numpy as np
import pytest

from synthetic_audio_detection_tpu.audio import dsp as jdsp
from synthetic_audio_detection_tpu_torch.audio import dsp, resample


def _signal(n, seed=0, sr=44_100):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t) + 0.05 * rng.standard_normal(n)
    return y.astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 7, 2048])
def test_windows(n):
    np.testing.assert_array_equal(dsp.hann(n), jdsp.hann(n))
    np.testing.assert_array_equal(dsp._hann_periodic(n), jdsp._hann_periodic(n))


@pytest.mark.parametrize("n_fft,hop,center", [(2048, None, True), (512, 128, True),
                                              (256, 100, False)])
def test_stft_istft(n_fft, hop, center):
    y = _signal(9_001).astype(np.float64)
    D = dsp.stft(y, n_fft, hop, center)
    np.testing.assert_array_equal(D, jdsp.stft(y, n_fft, hop, center))
    for length in (None, 8_000):
        np.testing.assert_array_equal(dsp.istft(D, hop, center, length),
                                      jdsp.istft(D, hop, center, length))


@pytest.mark.parametrize("rate", [0.5, 0.913, 1.0, 1.37])
def test_phase_vocoder_and_time_stretch(rate):
    y = _signal(20_000, seed=1)
    D = dsp.stft(y.astype(np.float64), 1024, 256)
    np.testing.assert_array_equal(dsp.phase_vocoder(D, rate, 256),
                                  jdsp.phase_vocoder(D, rate, 256))
    got = dsp.time_stretch(y, rate)
    assert got.dtype == np.float32 and len(got) == int(round(len(y) / rate))
    np.testing.assert_array_equal(got, jdsp.time_stretch(y, rate))


def test_time_stretch_rejects_a_non_positive_rate():
    with pytest.raises(ValueError, match="positive"):
        dsp.time_stretch(_signal(4096), 0.0)


@pytest.mark.parametrize("steps", [-2.0, -0.37, 0.0, 1.5, 2.0])
def test_pitch_shift(steps):
    y = _signal(22_050, seed=2)
    got = dsp.pitch_shift(y, 44_100, steps)
    assert got.shape == y.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, jdsp.pitch_shift(y, 44_100, steps))


@pytest.mark.parametrize("orig,new", [(44_100, 32_000), (48_000, 32_000), (32_000, 44_100),
                                      (16_000, 32_000), (61, 64), (32_000, 32_000)])
def test_resample_poly_np(orig, new):
    y = _signal(10_007, seed=3)
    got = dsp.resample_poly_np(y, orig, new)
    np.testing.assert_array_equal(got, jdsp.resample_poly_np(y, orig, new))
    assert dsp.resample_poly_np is resample.resample_poly_np  # one kernel bank
