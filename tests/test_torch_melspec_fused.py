"""The factored log-mel kernel's decomposition (csrc/melspec_factored.cu) on
the CPU: its host tables (ops/cuda_melspec.dft_rows, band_plan, row_tiles),
its operation count (work) and a plain-torch emulation of its tiling against the plain version
(ops.melspec.log_mel_factored) and the JAX package's Pallas kernel in
interpret mode.

The emulation restates the kernel's launches: the reflect pad and bf16
rounding of launch 1 by its index formula; launch 2's tiles of 128 hop blocks
125 apart over all windows' blocks (frames with their 3-block halo), bands
of 128 bins f0 − 1 … f0 + 126 (the Hann taps' one-bin halo, bin −1 the
conj mirror of bin 1) as interleaved cos|sin columns, the phases, the Hann
taps, the power and each mel's sum over its span in the one band that owns
it; then launch 3's dB, clamp and standardization. The kernel itself runs
only on a GPU (tests/test_torch_cuda.py).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from synthetic_audio_detection_tpu.ops.pallas_melspec import fused_log_mel_factored
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import cuda_melspec as C
from synthetic_audio_detection_tpu_torch.ops import melspec as TM

CFG = SpectrogramConfig(mel_norm="slaney")


def _waves(batch, samples, seed):
    return (np.random.default_rng(seed).standard_normal((batch, samples)) * 0.3).astype(np.float32)


def pad_blocks(x: torch.Tensor, cfg) -> torch.Tensor:
    """Launch 1 by its index formula: sample p of a window's row is x[p −
    pad], reflected at both edges, for p < T + 2·pad, else 0 → [B·nb, hop]
    float32 (before the rounding to bf16)."""
    B, T = x.shape
    nb, _ = C.geometry(T, cfg)
    pad = cfg.n_fft // 2
    s = np.arange(nb * cfg.hop_length) - pad
    valid = s < T + pad
    s = np.where(s < 0, -s, np.where(s >= T, 2 * (T - 1) - s, s))
    out = torch.where(torch.from_numpy(valid), x[:, np.where(valid, s, 0)], 0.0)
    return out.reshape(B * nb, cfg.hop_length)


def _rotate(re, im, k):
    """(re, im) · (−j)^k, k per bin."""
    return (torch.where(k == 0, re, torch.where(k == 1, im, torch.where(k == 2, -re, -im))),
            torch.where(k == 0, im, torch.where(k == 1, -re, torch.where(k == 2, -im, re))))


def emulate_kernel(x: torch.Tensor, cfg, standardize=True, lowp_tail=False,
                   sample_rate=32_000) -> torch.Tensor:
    B, T = x.shape
    hop, n_mels = cfg.hop_length, cfg.n_mels
    nb, n_frames = C.geometry(T, cfg)
    c = C.FactoredMelKernel().constants(cfg, sample_rate, torch.device("cpu"))
    n_tiles = C.row_tiles(B, nb, n_frames)
    # the TMA's zero fill past the last block, and around the cos|sin rows
    # (a band with f0 = −3 starts 6 rows before them)
    a = torch.zeros(((n_tiles - 1) * C.TILE_FRAMES + C.TILE_ROWS, hop))
    a[:B * nb] = pad_blocks(x, cfg).to(torch.bfloat16).float()
    cs = torch.zeros((8 + c["cs"].shape[0] + 2 * C.BAND_BINS, hop))
    cs[8:8 + c["cs"].shape[0]] = c["cs"].float()
    tiles = a.unfold(0, C.TILE_ROWS, C.TILE_FRAMES).transpose(1, 2)  # [tiles, 128, hop]
    rows = torch.arange(n_tiles * C.TILE_FRAMES).reshape(n_tiles, C.TILE_FRAMES)
    win, frame = rows // nb, rows % nb
    valid = (win < B) & (frame < n_frames)
    weights = c["weights_lowp" if lowp_tail else "weights"]
    mel = torch.full((B, n_mels, n_frames), float("nan"))
    for band, f0 in enumerate(c["f0"].tolist()):
        y = tiles @ cs[8 + 2 * f0:8 + 2 * f0 + 2 * C.BAND_BINS].T  # [tiles, 128, 256]
        yr, yi = y[..., 0::2], y[..., 1::2]  # bins f0 − 1 … f0 + 126
        q = (f0 - 1 + torch.arange(C.BAND_BINS)) % 4  # bin −1: 3, conj(bin 1)'s phases
        xr, xi = yr[:, :C.TILE_FRAMES], yi[:, :C.TILE_FRAMES]
        for i in range(1, 4):
            rr, ri = _rotate(yr[:, i:i + C.TILE_FRAMES], yi[:, i:i + C.TILE_FRAMES], (i * q) % 4)
            xr, xi = xr + rr, xi + ri
        wr = 0.5 * xr[..., 1:-1] - 0.25 * (xr[..., :-2] + xr[..., 2:])
        wi = 0.5 * xi[..., 1:-1] - 0.25 * (xi[..., :-2] + xi[..., 2:])
        p = torch.nn.functional.pad(wr * wr + wi * wi, (1, 1))  # local bins 0 … 127
        if lowp_tail:
            p = p.to(torch.bfloat16).float()
        # each parity's running sum over its bins; a mel is stored at its last bin
        for par in range(2):
            q0, q1 = c["quads"][band, par].tolist()
            s = torch.zeros(p.shape[:2])
            for j in range(4 * q0, 4 * q1):
                s = s + p[..., j] * weights[band, par, j]
                m = int(c["ends"][band, par, j])
                if m >= 0:
                    mel[win[valid], m, frame[valid]] = s[valid]
                    s = torch.zeros(p.shape[:2])
    assert not torch.isnan(mel).any(), "a mel cell was not written"
    db = TM.amplitude_to_db(mel, cfg.top_db)
    out = TM.standardize(db, cfg.eps) if standardize else db
    return out.to(torch.bfloat16) if lowp_tail else out


@pytest.mark.parametrize("samples", [128_000, 32_000, 127_700, 1_100])
def test_launch1_index_formula_is_the_reflect_pad(samples):
    x = torch.from_numpy(_waves(2, samples, seed=30))
    blocks, n_frames = TM.factored_blocks(x, CFG)
    nb, frames = C.geometry(samples, CFG)
    assert blocks.shape == (2, nb, CFG.hop_length) and frames == n_frames
    assert torch.equal(pad_blocks(x, CFG), blocks.reshape(-1, CFG.hop_length))


@pytest.mark.parametrize("norm", [None, "slaney"])
def test_span_table_rebuilds_the_filterbank(norm):
    """K1's mel spans, over the significant bins, hold every nonzero weight
    of the filterbank the plain version multiplies."""
    fb = TM.config_filterbank(SpectrogramConfig(mel_norm=norm), 32_000)
    fb = fb[:TM.significant_bins(fb)]
    lo, off, w = TM.sparse_columns(fb)
    dense = np.zeros_like(fb)
    for m in range(fb.shape[1]):
        dense[lo[m]:lo[m] + off[m + 1] - off[m], m] = w[off[m]:off[m + 1]]
    np.testing.assert_array_equal(dense, fb)
    assert np.count_nonzero(w) == np.count_nonzero(fb) == off[-1]


@pytest.mark.parametrize("n_mels,f_max", [(128, 12_000.0), (64, 16_000.0), (40, 8_000.0)])
def test_band_plan_covers_every_bin_of_every_mel_once(n_mels, f_max):
    """Each mel is owned by exactly one band, and each bin of its span, with
    the bins on either side that its Hann taps read, lies among the 128
    bins f0 − 1 … f0 + 126 that the band transforms; f0 ≡ 1 (mod 4), so a
    band's local bin j has the phases of j mod 4."""
    cfg = SpectrogramConfig(mel_norm="slaney", n_mels=n_mels, f_max=f_max)
    fb = TM.config_filterbank(cfg, 32_000)
    n_sig = TM.significant_bins(fb)
    lo, off, _ = TM.sparse_columns(fb[:n_sig])
    f0, edges = C.band_plan(lo, off)
    assert edges[0] == 0 and edges[-1] == n_mels and np.all(np.diff(edges) > 0)
    owner = np.repeat(np.arange(len(f0)), np.diff(edges))
    covered = np.zeros((n_mels, n_sig + 1), np.int32)
    for m in range(n_mels):
        k, span = owner[m], off[m + 1] - off[m]
        bins = np.arange(lo[m], lo[m] + span)
        assert np.all((bins >= f0[k]) & (bins < f0[k] + C.BAND_OUT_BINS))
        assert np.all((bins - 1 >= f0[k] - 1) & (bins + 1 <= f0[k] + C.BAND_BINS - 2))
        covered[m, bins] += 1
    spans = [(lo[m], lo[m] + off[m + 1] - off[m]) for m in range(n_mels)]
    assert all(np.all(covered[m, a:b] == 1) for m, (a, b) in enumerate(spans))
    assert covered.sum() == off[-1] and np.all(f0 % 4 == 1) and np.all((f0 >= -3) & (f0 < n_sig))


def test_band_plan_refuses_a_mel_wider_than_a_band():
    lo = np.array([0, 10], np.int32)
    off = np.array([0, 5, 5 + C.BAND_OUT_BINS + 1], np.int32)
    with pytest.raises(ValueError, match="mel 1 spans"):
        C.band_plan(lo, off)


def test_band_plan_refuses_a_mel_without_weights():
    with pytest.raises(ValueError, match="mel 1 has no filterbank weight"):
        C.band_plan(np.array([3, 0, 5], np.int32), np.array([0, 4, 4, 9], np.int32))


@pytest.mark.parametrize("n_mels,f_max,f_min", [(128, 12_000.0, 20.0), (64, 16_000.0, 20.0),
                                                (256, 12_000.0, 0.0)])
def test_band_tables_rebuild_the_filterbank(n_mels, f_max, f_min):
    """The two running sums of each band (even and odd mels) hold every
    filterbank weight once, at its bin, end each mel at its last bin, and
    multiply-add once per weight but for the few bins that round a parity's
    bins out to groups of 4."""
    cfg = SpectrogramConfig(mel_norm="slaney", n_mels=n_mels, f_max=f_max, f_min=f_min)
    fb = TM.config_filterbank(cfg, 32_000)
    fb = fb[:TM.significant_bins(fb)]
    lo, off, w = TM.sparse_columns(fb)
    f0, edges = C.band_plan(lo, off)
    t = C.band_tables(lo, off, w, f0, edges)
    dense = np.zeros_like(fb)
    for k in range(len(f0)):
        for par in range(2):
            j = np.nonzero(t["weights"][k, par])[0]
            owned = np.arange(edges[k], edges[k + 1])
            if not j.size:  # a band that owns no mel of this parity
                assert not np.any(owned % 2 == par) and tuple(t["quads"][k, par]) == (0, 0)
                continue
            # bin → the parity's mel there: the next end at or after it
            ends = np.nonzero(t["ends"][k, par] >= 0)[0]
            mel_of = t["ends"][k, par][ends[np.searchsorted(ends, j)]]
            assert set(mel_of) == set(owned[owned % 2 == par])
            dense[f0[k] - 1 + j, mel_of] = t["weights"][k, par, j]
            q0, q1 = t["quads"][k, par]
            assert 4 * q0 <= j.min() and j.max() < 4 * q1
            assert q1 - q0 <= (j.max() - j.min()) // 4 + 2
    np.testing.assert_array_equal(dense, fb)
    steps = 4 * np.diff(t["quads"], axis=-1).sum()
    assert off[-1] <= steps < 1.1 * off[-1]


def test_dft_rows_interleave_cos_sin_with_mirror_and_guard():
    cos_m, sin_m = TM._dft_matrices(2048, 769)
    rows = C.dft_rows(2048, 512, 768)
    assert rows.shape == (2 * 770, 512)
    np.testing.assert_array_equal(rows[2::2], cos_m[:512].T)
    np.testing.assert_array_equal(rows[3::2], sin_m[:512].T)
    np.testing.assert_array_equal(rows[0], cos_m[:512, 1])   # bin −1 = conj(bin 1)
    np.testing.assert_array_equal(rows[1], -sin_m[:512, 1])
    np.testing.assert_array_equal(rows[-2], cos_m[:512, 768])  # the guard bin


@pytest.mark.parametrize("batch,samples", [(1, 128_000), (3, 32_000), (5, 127_700), (128, 128_000)])
def test_row_tiles_hold_every_frame_once(batch, samples):
    """Every frame starts in exactly one tile, its 4 blocks lie in that
    tile and in its own window, and the last tile holds a frame."""
    nb, n_frames = C.geometry(samples, CFG)
    n_tiles = C.row_tiles(batch, nb, n_frames)
    starts = np.arange(n_tiles * C.TILE_FRAMES)
    win, frame = starts // nb, starts % nb
    valid = (win < batch) & (frame < n_frames)
    assert valid.sum() == batch * n_frames and valid[-C.TILE_FRAMES:].any()
    assert np.all(frame[valid] + 3 < nb)  # the frame's last block is its window's
    # a tile's rows: [125·tile, 125·tile + 128); a frame's blocks: start … start + 3
    assert np.all(starts % C.TILE_FRAMES + 3 < C.TILE_ROWS)


@pytest.mark.parametrize("batch,samples", [(128, 128_000), (5, 127_700), (3, 32_000)])
def test_work_counts_the_function_and_the_tiling_apart(batch, samples):
    """The bound's operations are the function's (each hop block against
    the bins up to the guard bin, one multiply-add per filterbank nonzero);
    the tiling's halos and groups of 4 bins come on top."""
    c = C.FactoredMelKernel().constants(CFG, 32_000, torch.device("cpu"))
    fb = TM.config_filterbank(CFG, 32_000)
    n_sig = TM.significant_bins(fb)
    nb, n_frames = C.geometry(samples, CFG)
    w = C.work(c, CFG, batch, samples)
    assert w["dft_min"] == 2 * batch * nb * 512 * 2 * (n_sig + 1)
    assert w["mel_min"] == 2 * batch * n_frames * np.count_nonzero(fb[:n_sig])
    tiles = C.row_tiles(batch, nb, n_frames)
    assert w["dft"] == 2 * tiles * C.TILE_ROWS * len(c["f0"]) * 2 * C.BAND_BINS * 512
    assert w["dft"] > w["dft_min"] and 1.0 <= w["mel"] / w["mel_min"] < 1.1
    if (batch, samples) == (128, 128_000):  # the figures chip_smoke prints
        assert (round(w["dft_min"] / 1e9, 2), round(w["dft"] / 1e9, 2)) == (51.20, 61.30)


MODES = [(True, False), (False, False), (True, True), (False, True)]  # (standardize, lowp_tail)


def _tolerance(ref, x, standardize, lowp_tail):
    """Summation order only: 1e-4 on z-scores, 1e-3 dB; under lowp_tail the
    bound of two bf16 mel products (cuda_melspec.lowp_tail_tolerance) on
    top."""
    tol = 1e-4 if standardize else 1e-3
    if not lowp_tail:
        return tol
    db_std = TM.log_mel_factored(x, CFG, standardize=False).std(dim=(1, 2))
    return C.lowp_tail_tolerance(ref, db_std if standardize else None) + tol


@functools.lru_cache(maxsize=None)
def _emulated(batch, samples, standardize, lowp_tail):
    """(waveforms, the emulation's output), shared by the two comparisons."""
    waves = _waves(batch, samples, seed=31)
    return waves, emulate_kernel(torch.from_numpy(waves), CFG, standardize, lowp_tail)


@pytest.mark.parametrize("standardize,lowp_tail", MODES)
@pytest.mark.parametrize("batch,samples", [(2, 128_000), (3, 32_000)])
def test_tiling_matches_plain_version(batch, samples, standardize, lowp_tail):
    waves, got = _emulated(batch, samples, standardize, lowp_tail)
    x = torch.from_numpy(waves)
    ref = TM.log_mel_factored(x, CFG, standardize=standardize, dft_dtype=torch.bfloat16,
                              lowp_tail=lowp_tail)
    assert got.shape == ref.shape == (batch, 128, 1 + samples // 512) and got.dtype == ref.dtype
    assert bool(((got.float() - ref.float()).abs() <= _tolerance(ref, x, standardize,
                                                                 lowp_tail)).all())


@pytest.mark.parametrize("standardize,lowp_tail", MODES)
@pytest.mark.parametrize("batch,samples", [(2, 128_000), (3, 32_000)])
def test_tiling_matches_pallas_kernel(batch, samples, standardize, lowp_tail):
    """At bf16 DFT on both sides, as test_torch_melspec.py holds the plain
    version to the Pallas kernel in interpret mode."""
    waves, got = _emulated(batch, samples, standardize, lowp_tail)
    ref = fused_log_mel_factored(jnp.asarray(waves), CFG, interpret=True,
                                 standardize=standardize, lowp_tail=lowp_tail)
    ref = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref.shape
    x = torch.from_numpy(waves)
    assert bool(((got.float() - ref).abs() <= _tolerance(ref, x, standardize, lowp_tail)).all())


def test_tiling_mirrors_bin_minus_one_for_a_mel_at_bin_0(monkeypatch):
    """A mel that weighs bin 0 puts its band at f0 = −3, whose local bin 3
    is the table's bin −1, conj(bin 1): the Hann tap X[−1] = conj(X[1]) of
    the plain version. (The triangular filterbanks give bin 0 no weight for
    f_min ≥ 0, so the defaults never reach this row.)"""
    config_filterbank = TM.config_filterbank

    def with_bin_0(cfg, sample_rate):
        fb = config_filterbank(cfg, sample_rate).copy()
        fb[0, 0] = fb[1:, 0].max()
        return fb

    monkeypatch.setattr(TM, "config_filterbank", with_bin_0)
    x = torch.from_numpy(_waves(1, 32_000, seed=33))
    assert C.FactoredMelKernel().constants(CFG, 32_000, torch.device("cpu"))["f0"][0] == -3
    got = emulate_kernel(x, CFG)
    ref = TM.log_mel_factored(x, CFG, dft_dtype=torch.bfloat16)
    assert bool(((got - ref).abs() <= 1e-4).all())
