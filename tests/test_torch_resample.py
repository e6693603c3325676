"""The port's device resampler (``ops/resample.py``) against the JAX
package's ``ops/resample.resample`` and the host ``resample_poly_np``, on
the CPU. Both packages apply the same float32 sinc bank as a strided
convolution and differ only in the summation order: 1e-5 absolute on
signals of amplitude O(1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.ops import resample as JR
from synthetic_audio_detection_tpu_torch.audio.resample import resample_poly_np
from synthetic_audio_detection_tpu_torch.ops import resample as TR

RATES = [(44_100, 32_000), (48_000, 32_000), (16_000, 32_000), (22_050, 32_000),
         (32_000, 48_000)]


def _signal(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("orig,new", RATES)
def test_resample_matches_jax_and_the_host_resampler(orig, new):
    x = _signal((2, orig + 137), orig)
    got = TR.resample(torch.from_numpy(x), orig, new).numpy()
    ref = np.asarray(JR.resample(jnp.asarray(x), orig, new))
    assert got.shape == ref.shape == (2, -(-(orig + 137) * new // orig))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], resample_poly_np(x[1], orig, new), rtol=0, atol=1e-5)


def test_output_length_and_batch_shape():
    assert TR.resample(torch.zeros(44_100), 44_100, 32_000).shape == (32_000,)
    assert TR.resample(torch.zeros(3, 22_050), 22_050, 32_000).shape == (3, 32_000)
    assert TR.resample(torch.zeros(2, 3, 1000), 48_000, 32_000).shape == (2, 3, 667)


def test_identity_when_equal_rates():
    x = torch.from_numpy(_signal(1000, 1))
    assert TR.resample(x, 32_000, 32_000) is x
    y = _signal(1000, 2)
    np.testing.assert_array_equal(TR.resample_bucketed(y, 32_000, 32_000, device="cpu"), y)


@pytest.mark.parametrize("T", [44_100 * 3 + 17, 44_100 // 2, 44_100 * 7])
def test_bucketed_matches_unbucketed_and_jax(T):
    x = _signal(T, T)
    direct = TR.resample(torch.from_numpy(x), 44_100, 32_000).numpy()
    bucketed = TR.resample_bucketed(x, 44_100, 32_000, bucket_seconds=2.0, device="cpu")
    assert bucketed.shape == direct.shape
    np.testing.assert_allclose(bucketed, direct, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bucketed, JR.resample_bucketed(x, 44_100, 32_000,
                                                              bucket_seconds=2.0),
                               rtol=0, atol=1e-5)


def test_bucketed_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.resample_bucketed(_signal(1000, 3), 44_100, 32_000)
