"""The port's profile scripts: what they can show without a GPU (the
kernel-name classification and busy-time arithmetic) and that they refuse
to run without one."""

import pytest
import torch

from synthetic_audio_detection_tpu_torch.tools import profile_serving as P


@pytest.mark.parametrize("name,part", [
    ("void (anonymous namespace)::conv3x3_kernel<false>(...)", "conv kernel (K3)"),
    ("void (anonymous namespace)::conv3x3_wgmma_kernel<2, 64, false>(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::Params)", "conv kernel (K3)"),
    # the bench's tile shapes, float32 out too: before the "conv" keys of cuDNN's kernels
    ("void (anonymous namespace)::conv3x3_wgmma_kernel<1, 256, false>(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::Params)", "conv kernel (K3)"),
    ("void (anonymous namespace)::conv3x3_wgmma_kernel<2, 128, true>(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::Params)", "conv kernel (K3)"),
    ("void (anonymous namespace)::pad_bf16_kernel<float>(...)", "K1 log-mel kernel"),
    ("(anonymous namespace)::dft_mel_kernel(CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::Params)", "K1 log-mel kernel"),
    ("void (anonymous namespace)::db_standardize_kernel<__nv_bfloat16>(...)", "K1 log-mel kernel"),
    ("(anonymous namespace)::strip_bf16_kernel(...)", "K2 log-mel kernel"),
    ("(anonymous namespace)::strip_dft_kernel(CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::Params)", "K2 log-mel kernel"),
    ("(anonymous namespace)::strip_tail_kernel(...)", "K2 log-mel kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "H2D copy"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "cuDNN convolutions"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32_cgasize1x2x1", "GEMM (mel DFT)"),
    ("ampere_sgemm_128x64_nn", "GEMM (mel DFT)"),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, false, false, true>",
     "cuDNN convolutions"),
    ("void at::native::batch_norm_transform_input_channels_last_kernel<c10::BFloat16, float>",
     "BatchNorm (eval)"),
    ("void at::native::max_pool_forward_nhwc<c10::BFloat16>", "max-pool"),
    ("void at::native::upsample_bilinear2d_out_frame<float>", "resize"),
    ("vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::BFloat16>>",
     "add (BN bias, residual)"),
    ("vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, float, "
     "at::native::binary_internal::MulFunctor<float>>>", "multiply (BN scale)"),
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


def test_profile_script_parses_the_stage_decomposition_flags():
    """--input-size and --mono, the flags of benchmarks/stage_decomp.py that
    round 4's native step passes, beside the defaults (512², RGB stem)."""
    args = P.build_parser().parse_args([])
    assert (args.input_size, args.mono, args.device, args.routes) == (512, False, "cuda",
                                                                      "knob-0,kernel")
    args = P.build_parser().parse_args(["--input-size", "native", "--mono", "--device", "cuda:1"])
    assert (args.input_size, args.mono, args.device) == (0, True, "cuda:1")
    assert P.build_parser().parse_args(["--input-size", "256"]).input_size == 256
    with pytest.raises(SystemExit):
        P.build_parser().parse_args(["--input-size", "wide"])


def test_profile_script_runs_on_cuda_only(capsys):
    assert P.main(["--input-size", "native", "--mono", "--device", "cpu"]) == 1
    assert "runs on CUDA only, not cpu" in capsys.readouterr().err


def test_train_profile_script_needs_a_gpu(capsys):
    from synthetic_audio_detection_tpu_torch.tools import profile_train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profile_train.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err



def test_log_mel_kernel_names_do_not_contain_one_another():
    """K1's and K2's launches are told apart whatever the order of the
    table: no launch name of one contains another's."""
    keys = [k for part, names in P.PARTS if "log-mel" in part for k in names]
    assert len(keys) == 6
    assert not [(a, b) for a in keys for b in keys if a != b and a in b]
