"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports neither JAX nor the test suite's conftest, so it also runs where
JAX is absent (the GPU machine):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each test decides inside itself whether a CUDA device is present and skips
without one.
"""

import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import cuda_melspec, melspec

CFG = SpectrogramConfig(mel_norm="slaney")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _waves(batch, samples, seed=5):
    x = np.random.default_rng(seed).standard_normal((batch, samples)) * 0.3
    return torch.from_numpy(x.astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("batch,samples", [(4, 128_000), (3, 32_000)])
def test_factored_mel_kernel_matches_plain_version(standardize, batch, samples):
    """Same inputs, bf16 DFT operands on both sides: the float32 summation
    order of the DFT and mel products is all that differs (1e-3 on z-scores,
    1e-2 dB)."""
    _cuda_or_skip()
    x = _waves(batch, samples)
    before = cuda_melspec.KERNEL.launches
    got = cuda_melspec.fused_log_mel_factored(x, CFG, standardize=standardize)
    ref = melspec.log_mel_factored(x, CFG, standardize=standardize, dft_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_melspec.KERNEL.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 if standardize else 1e-2)


@pytest.mark.cuda
def test_factored_mel_kernel_is_deterministic_and_takes_int16():
    _cuda_or_skip()
    x = _waves(8, 128_000)
    a = cuda_melspec.fused_log_mel_factored(x, CFG)
    assert torch.equal(a, cuda_melspec.fused_log_mel_factored(x, CFG))
    pcm = torch.round(x * 32768).clamp(-32768, 32767).to(torch.int16)
    torch.testing.assert_close(cuda_melspec.fused_log_mel_factored(pcm, CFG),
                               cuda_melspec.fused_log_mel_factored(pcm.float() / 32768.0, CFG),
                               rtol=0, atol=0)
