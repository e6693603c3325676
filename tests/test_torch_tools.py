"""The port's profile script: what it can show without a GPU (its kernel-name
classification and busy-time arithmetic) and that it refuses to run
without one."""

import pytest
import torch

from synthetic_audio_detection_tpu_torch.tools import profile_serving as P


@pytest.mark.parametrize("name,part", [
    ("void (anonymous namespace)::conv3x3_kernel<false>(...)", "conv kernel (K3)"),
    ("block_dft_kernel", "K1 log-mel kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "H2D copy"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "cuDNN convolutions"),
    ("void at::native::max_pool_forward_nhwc<c10::BFloat16>", "max-pool"),
    ("void at::native::upsample_bilinear2d_out_frame<float>", "resize"),
    ("vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::BFloat16>>",
     "add (bias, residual)"),
    ("vectorized_elementwise_kernel<4, at::native::launch_clamp_scalar>", "ReLU"),
    ("something_else", "other"),
])
def test_profile_parts(name, part):
    assert P.classify(name) == part


def test_busy_time_is_the_union_of_intervals():
    assert P.busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert P.busy_us([]) == 0


def test_profile_script_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert P.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
