"""The port's helper probes P1-P3 (ops/cuda_probes.py, tools/helper_bisect.py)
against the Pallas probes of benchmarks/pallas_helper_bisect.py, on the CPU.

The three Pallas kernels are closures inside that script's ``main``, so they
are restated here verbatim (:44-88) and run in interpret mode. Inputs are
seeded numpy bf16 values. Both sides form every bf16 product exactly in
float32 and sum in float32 in different orders, then round once to bf16, so
they agree to one bf16 ulp (2^-7·|ref|, plus 1e-5 for sums near 0) where
the two sums straddle a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from synthetic_audio_detection_tpu_torch.ops import build, cuda_probes
from synthetic_audio_detection_tpu_torch.tools import helper_bisect

BF16_ULP = 2.0 ** -7


def k1(x_ref, w_ref, o_ref):
    t = pl.program_id(1)
    rows = x_ref[0, pl.dslice(t * 256 + 3, 256), :]
    o_ref[0, :, :] = jax.lax.dot_general(
        rows, w_ref[...], dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32).astype(o_ref.dtype)


def k2(x_ref, w_ref, o_ref):
    a = x_ref[0, 0:256, :]
    b = x_ref[0, 1:257, :]
    p = jnp.concatenate([a, b], axis=-1)
    wp = jnp.concatenate([w_ref[...], w_ref[...]], axis=0)
    o_ref[0, :, :] = jax.lax.dot_general(
        p, wp, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32).astype(o_ref.dtype)


def k3(x_ref, w_ref, o_ref):
    acc = jnp.zeros((256, 64), jnp.float32)
    for i in range(9):
        acc = acc + jax.lax.dot_general(
            x_ref[0, i:i + 256, :], w_ref[i],
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
    o_ref[0, :, :] = acc.astype(o_ref.dtype)


def _pallas(probe, A, W):
    if probe == "P1":
        return pl.pallas_call(
            k1, grid=(2, 7),
            in_specs=[pl.BlockSpec((1, 2048, 64), lambda b, t: (b, 0, 0)),
                      pl.BlockSpec((64, 64), lambda b, t: (0, 0))],
            out_specs=pl.BlockSpec((1, 256, 64), lambda b, t: (b, t, 0)),
            out_shape=jax.ShapeDtypeStruct((2, 1792, 64), jnp.bfloat16), interpret=True)(A, W)
    if probe == "P2":
        return pl.pallas_call(
            k2, grid=(2,),
            in_specs=[pl.BlockSpec((1, 2048, 64), lambda b: (b, 0, 0)),
                      pl.BlockSpec((64, 64), lambda b: (0, 0))],
            out_specs=pl.BlockSpec((1, 256, 64), lambda b: (b, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((2, 256, 64), jnp.bfloat16), interpret=True)(A, W)
    return pl.pallas_call(
        k3, grid=(2,),
        in_specs=[pl.BlockSpec((1, 2048, 64), lambda b: (b, 0, 0)),
                  pl.BlockSpec((9, 64, 64), lambda b: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, 256, 64), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((2, 256, 64), jnp.bfloat16), interpret=True)(A, W)


ENTRIES = {"P1": cuda_probes.dyn_slice_dot, "P2": cuda_probes.lane_concat_dot,
           "P3": cuda_probes.nine_tap_dot}
W_SHAPES = {"P1": (64, 64), "P2": (64, 64), "P3": (9, 64, 64)}


def _inputs(probe, seed):
    """bf16 values from numpy; W scaled so the sums stay O(1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(cuda_probes.X_SHAPE).astype(np.float32)
    w = (rng.standard_normal(W_SHAPES[probe]) / 8).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("probe", sorted(ENTRIES))
def test_probe_matches_pallas(probe, seed):
    x, w = _inputs(probe, seed)
    ref = np.asarray(_pallas(probe, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(w.float().numpy()).astype(jnp.bfloat16))
                     ).astype(np.float32)
    got = ENTRIES[probe](x, w)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=BF16_ULP, atol=1e-5)


# (taps, row0, output rows per image, entry's plain version) of each probe
PLANS = {"P1": (1, cuda_probes.P1_ROW0, cuda_probes.TILE * cuda_probes.P1_TILES,
                cuda_probes.dyn_slice_dot_plain),
         "P2": (2, 0, cuda_probes.TILE, cuda_probes.lane_concat_dot_plain),
         "P3": (9, 0, cuda_probes.TILE, cuda_probes.nine_tap_dot_plain)}


@pytest.mark.parametrize("probe", sorted(PLANS))
def test_tiles_cover_every_output_row_once(probe):
    """The kernel's plan: 64-row tiles, one block each per image (P1 28, P2
    and P3 4), whose output rows are every row of the probe once."""
    taps, row0, rows_out, _ = PLANS[probe]
    plan = cuda_probes.tiles(rows_out, taps, row0)
    assert plan.shape == (rows_out // cuda_probes.TILE_ROWS, taps)
    assert cuda_probes.X_SHAPE[0] * len(plan) == {"P1": 56, "P2": 8, "P3": 8}[probe]
    rows = np.concatenate([cuda_probes.TILE_ROWS * t + np.arange(cuda_probes.TILE_ROWS)
                           for t in range(len(plan))])
    np.testing.assert_array_equal(np.sort(rows), np.arange(rows_out))


@pytest.mark.parametrize("probe", sorted(PLANS))
def test_every_tap_box_lies_inside_the_input(probe):
    """Tap i of tile t reads the 64 rows from row0 + 64·t + i on, all inside
    x's 2048 rows (the kernel's entry refuses a plan that is not)."""
    taps, row0, rows_out, _ = PLANS[probe]
    plan = cuda_probes.tiles(rows_out, taps, row0)
    t = np.arange(len(plan))[:, None]
    np.testing.assert_array_equal(plan, row0 + cuda_probes.TILE_ROWS * t + np.arange(taps))
    assert plan.min() >= 0
    assert plan.max() + cuda_probes.TILE_ROWS <= cuda_probes.X_SHAPE[1]
    assert not plan.flags.writeable


def test_tiles_refuse_rows_that_are_not_whole_tiles():
    with pytest.raises(ValueError, match="multiple of 64"):
        cuda_probes.tiles(100, 1, 0)
    with pytest.raises(ValueError, match="multiple of 64"):
        cuda_probes.tiles(0, 1, 0)


def _emulate(x, w, taps, row0, rows_out):
    """The kernel's arithmetic walked tile by tile over its plan: each
    tile's taps summed in float32 from their own A boxes, rounded once."""
    ws = [w] * taps if w.dim() == 2 else list(w)
    out = torch.empty((x.shape[0], rows_out, w.shape[-1]), dtype=torch.bfloat16)
    n = cuda_probes.TILE_ROWS
    for b in range(x.shape[0]):
        for t, starts in enumerate(cuda_probes.tiles(rows_out, taps, row0)):
            acc = torch.zeros((n, w.shape[-1]), dtype=torch.float32)
            for wi, r in zip(ws, starts):
                acc += x[b, r:r + n].float() @ wi.float()
            out[b, n * t:n * (t + 1)] = acc.to(torch.bfloat16)
    return out


@pytest.mark.parametrize("probe", sorted(PLANS))
def test_tiled_emulation_matches_plain_and_pallas(probe):
    """The plan computes each probe: walked tile by tile it agrees with the
    plain version and the restated Pallas probe to one bf16 ulp (the same
    exact products summed in another order)."""
    taps, row0, rows_out, plain = PLANS[probe]
    x, w = _inputs(probe, 3)
    got = _emulate(x, w, taps, row0, rows_out).float()
    ref = plain(x, w).float()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=BF16_ULP, atol=1e-5)
    pallas = np.asarray(_pallas(probe, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(w.float().numpy()).astype(jnp.bfloat16))
                        ).astype(np.float32)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=BF16_ULP, atol=1e-5)


def test_helper_bisect_prints_the_exact_sums(capsys):
    assert helper_bisect.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "F1 dyn-dslice : OK 14680064.0",
        "F2 lane-concat : OK 4194304.0",
        "F3 9-tap-static : OK 18874368.0",
    ]


def test_helper_bisect_swallows_no_failure(capsys, monkeypatch):
    """A wrong sum and a raised error each print FAIL, and the exit code is
    1 (the TPU script printed FAIL and exited 0)."""
    def raises(x, w):
        raise RuntimeError("launch failed")

    probes = list(helper_bisect.PROBES)
    probes[0] = ("F1 dyn-dslice", lambda x, w: cuda_probes.dyn_slice_dot(x, w) * 2, "w",
                 probes[0][3])
    probes[2] = ("F3 9-tap-static", raises, "w9", probes[2][3])
    monkeypatch.setattr(helper_bisect, "PROBES", probes)
    assert helper_bisect.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("F1 dyn-dslice : FAIL sum 29360128.0")
    assert out[1] == "F2 lane-concat : OK 4194304.0"
    assert out[2].startswith("F3 9-tap-static : FAIL RuntimeError('launch failed')")


def test_helper_bisect_needs_a_gpu_for_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert helper_bisect.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_probe_source_is_in_the_checkout():
    assert cuda_probes.SOURCE.endswith(f"csrc/{cuda_probes.LIBRARY}.cu")
    assert (build.CSRC_DIR / f"{cuda_probes.LIBRARY}.cu").exists()
    assert sorted(cuda_probes.REPLACES) == sorted(ENTRIES)


def _bad_calls():
    x = torch.zeros(cuda_probes.X_SHAPE, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    w9 = torch.zeros(9, 64, 64, dtype=torch.bfloat16)
    return {
        "batch": (cuda_probes.dyn_slice_dot, torch.zeros(3, 2048, 64, dtype=torch.bfloat16), w,
                  r"x must be \[2, 2048, 64\]"),
        "rows": (cuda_probes.lane_concat_dot, x[:, :1024].contiguous(), w, "x must be"),
        "weight": (cuda_probes.nine_tap_dot, x, w, r"w \[9, 64, 64\]"),
        "taps_weight": (cuda_probes.dyn_slice_dot, x, w9, r"w \[64, 64\]"),
        "float32_x": (cuda_probes.dyn_slice_dot, x.float(), w, "bfloat16"),
        "float32_w": (cuda_probes.nine_tap_dot, x, w9.float(), "bfloat16"),
        "not_contiguous": (cuda_probes.lane_concat_dot, x, w.t(), "contiguous"),
        "meta_device": (cuda_probes.dyn_slice_dot, x.to("meta"), w.to("meta"), "device"),
        "mixed_devices": (cuda_probes.nine_tap_dot, x, w9.to("meta"), "w on meta"),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_probe_entries_raise_on_what_the_kernel_does_not_take(case):
    """The entries check on every device what the kernel takes, so the CPU
    path accepts exactly what the card does; another device raises instead
    of falling back."""
    fn, x, w, match = _bad_calls()[case]
    with pytest.raises(ValueError, match=match):
        fn(x, w)
