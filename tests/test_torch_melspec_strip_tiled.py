"""The strip log-mel kernel's decomposition (csrc/melspec_strip.cu) on the
CPU: its host tables (ops/cuda_melspec_strip.band_plan, tiles, and the
factored kernel's band_tables at its band width), its operation count
(work) and a plain-torch emulation of its tiling against the plain version
(ops.melspec.log_mel_strip) and the JAX package's Pallas kernel in
interpret mode.

The emulation restates the kernel's three launches: launch 1's Hann-weighted
bf16 strips by its index formula (reflect pad and zero tail from the
unpadded waveforms); launch 2's tiles of 128 frame rows over all windows'
rows back to back (a frame is row r + i of strip i), bands of 128 bins
f0 … f0 + 127 as interleaved cos|sin columns, the power from each re|im
pair, and each parity's running sum over its bins with a mel stored at its
last bin; then launch 3's dB, clamp and standardization. The kernel itself
runs only on a GPU (tests/test_torch_cuda.py).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from synthetic_audio_detection_tpu.ops.pallas_melspec import fused_log_mel
from synthetic_audio_detection_tpu.utils.config import SpectrogramConfig
from synthetic_audio_detection_tpu_torch.ops import cuda_melspec
from synthetic_audio_detection_tpu_torch.ops import cuda_melspec_strip as K
from synthetic_audio_detection_tpu_torch.ops import melspec as TM

CFG = SpectrogramConfig(mel_norm="slaney")
# the emulation against the plain version and the Pallas kernel: the same
# bf16 operands, every product exact in float32, only the float32 summation
# order of the DFT and the mel product differs (tests/test_torch_melspec_strip.py)
TOL_Z = 1e-4


def _waves(batch, samples, seed):
    return (np.random.default_rng(seed).standard_normal((batch, samples)) * 0.3).astype(np.float32)


def strips(x: torch.Tensor, cfg) -> torch.Tensor:
    """Launch 1 by its index formula: sample p of a window's padded row is
    x[p − pad], reflected at both edges, for p < T + 2·pad, else 0; strip i
    of hop block h is bf16(sample h·hop + s × hann[i·hop + s]), the product
    in float32 → [k, B·nb, hop] bf16."""
    B, T = x.shape
    hop, k = cfg.hop_length, cfg.n_fft // cfg.hop_length
    nb, _ = cuda_melspec.geometry(T, cfg)
    s = np.arange(nb * hop) - cfg.n_fft // 2
    valid = s < T + cfg.n_fft // 2
    s = np.where(s < 0, -s, np.where(s >= T, 2 * (T - 1) - s, s))
    xpad = torch.where(torch.from_numpy(valid), x[:, np.where(valid, s, 0)], 0.0)
    hann = torch.from_numpy(TM.hann_window(cfg.n_fft)).reshape(k, 1, hop)
    return (xpad.reshape(1, B * nb, hop) * hann).to(torch.bfloat16)


def emulate_kernel(x: torch.Tensor, cfg, sample_rate=32_000) -> torch.Tensor:
    B, T = x.shape
    n_fft, k, n_mels = cfg.n_fft, cfg.n_fft // cfg.hop_length, cfg.n_mels
    nb, n_frames = cuda_melspec.geometry(T, cfg)
    c = K.StripMelKernel().constants(cfg, sample_rate, torch.device("cpu"))
    n_tiles = K.tiles(B, nb, n_frames)
    n_rows = n_tiles * K.TILE_ROWS
    # the TMA's zero fill past the last row of a strip and past the table
    s = torch.zeros((k, n_rows + k, cfg.hop_length))
    s[:, :B * nb] = strips(x, cfg).float()
    cs = torch.zeros((c["cs"].shape[0] + 2 * K.BAND_BINS, n_fft))
    cs[:c["cs"].shape[0]] = c["cs"].float()
    # row r of a tile's A: rows r + i of strips i = 0 … k − 1, one frame
    a = torch.cat([s[i, i:i + n_rows] for i in range(k)], dim=1).reshape(n_tiles, K.TILE_ROWS,
                                                                          n_fft)
    rows = torch.arange(n_rows).reshape(n_tiles, K.TILE_ROWS)
    win, frame = rows // nb, rows % nb
    valid = (win < B) & (frame < n_frames)
    mel = torch.full((B, n_mels, n_frames), float("nan"))
    for band, f0 in enumerate(c["f0"].tolist()):
        y = a @ cs[2 * f0:2 * f0 + 2 * K.BAND_BINS].T  # [tiles, 128, 256]: bins f0 … f0 + 127
        p = y[..., 0::2] * y[..., 0::2] + y[..., 1::2] * y[..., 1::2]
        # each parity's running sum over its bins; a mel is stored at its last bin
        for par in range(2):
            q0, q1 = c["quads"][band, par].tolist()
            acc = torch.zeros(p.shape[:2])
            for j in range(4 * q0, 4 * q1):
                acc = acc + p[..., j] * c["weights"][band, par, j]
                m = int(c["ends"][band, par, j])
                if m >= 0:
                    mel[win[valid], m, frame[valid]] = acc[valid]
                    acc = torch.zeros(p.shape[:2])
    assert not torch.isnan(mel).any(), "a mel cell was not written"
    return TM.standardize(TM.amplitude_to_db(mel, cfg.top_db), cfg.eps)


@pytest.mark.parametrize("samples", [128_000, 32_000, 127_700, 1_100])
def test_launch1_strips_are_the_windowed_frames(samples):
    """Row t + i of strip i is the i-th hop of frame t times the window,
    rounded once to bf16, as the plain version rounds it."""
    x = torch.from_numpy(_waves(2, samples, seed=40))
    nb, n_frames = cuda_melspec.geometry(samples, CFG)
    got = strips(x, CFG)
    frames = TM.frame_signal(x, CFG.n_fft, CFG.hop_length, True, "reflect")
    xw = (frames * torch.from_numpy(TM.hann_window(CFG.n_fft))).to(torch.bfloat16)
    assert got.shape == (4, 2 * nb, CFG.hop_length) and frames.shape[1] == n_frames
    for i in range(4):
        rows = (torch.arange(2)[:, None] * nb + torch.arange(n_frames) + i).reshape(-1)
        part = xw[..., i * CFG.hop_length:(i + 1) * CFG.hop_length].reshape(-1, CFG.hop_length)
        assert torch.equal(got[i, rows], part)


@pytest.mark.parametrize("norm", [None, "slaney"])
@pytest.mark.parametrize("n_mels,f_max", [(128, 12_000.0), (96, 12_000.0), (64, 16_000.0)])
def test_band_plan_and_tables_rebuild_the_filterbank(norm, n_mels, f_max):
    """Each mel's whole span lies among the 128 bins f0 … f0 + 127 of the one
    band that owns it, and the two running sums of each band (even and odd
    mels) hold every weight of the strip filterbank once, at its bin, and
    end each mel at its last bin. At 96 mels, mels end at a band's last bin
    (local 127); every band's first mel starts at its first bin."""
    cfg = SpectrogramConfig(mel_norm=norm, n_mels=n_mels, f_max=f_max)
    c = K.StripMelKernel().constants(cfg, 32_000, torch.device("cpu"))
    fb = TM.strip_filterbank(TM.config_filterbank(cfg, 32_000))
    lo, off, _ = TM.sparse_columns(fb)
    f0 = c["f0"].numpy()
    weights, ends = c["weights"].numpy(), c["ends"].numpy()
    dense = np.zeros_like(fb)
    last = []
    for band in range(len(f0)):
        starts = []
        for par in range(2):
            j = np.nonzero(weights[band, par])[0]
            if not j.size:
                continue
            stops = np.nonzero(ends[band, par] >= 0)[0]
            mel_of = ends[band, par][stops[np.searchsorted(stops, j)]]
            spans = [(lo[m] - f0[band], lo[m] + off[m + 1] - off[m] - f0[band]) for m in mel_of]
            assert all(0 <= a and b <= K.BAND_BINS for a, b in spans)
            dense[f0[band] + j, mel_of] = weights[band, par, j]
            starts.append(min(a for a, _ in spans))
            last.append(stops.max())
        assert min(starts) == 0
    np.testing.assert_array_equal(dense, fb)
    assert (K.BAND_BINS - 1 in last) == (n_mels == 96)
    if (n_mels, f_max) == (128, 12_000.0):
        # 7 bands of 128 bins for the 768 bins of the table: 1.167× its DFT
        assert len(f0) == 7 and c["cs"].shape == (2 * 768, CFG.n_fft)


@pytest.mark.parametrize("batch,samples", [(1, 128_000), (3, 32_000), (5, 127_700),
                                           (2, 1_100), (128, 128_000), (1, 1_025),
                                           (2, 64_000), (7, 16_000), (16, 128_000),
                                           (64, 128_000)])
def test_tiles_hold_every_frame_once(batch, samples):
    """Tiles partition the rows, every frame's first row lies in a tile, a
    frame's k rows lie in its own window, the tiles fill whole clusters and
    the last cluster holds a frame, and at [128, 128000] 1.2% of the rows
    start no frame."""
    nb, n_frames = cuda_melspec.geometry(samples, CFG)
    n = K.tiles(batch, nb, n_frames)
    assert n % K.CLUSTER == 0
    rows = np.arange(n * K.TILE_ROWS)
    win, frame = rows // nb, rows % nb
    valid = (win < batch) & (frame < n_frames)
    assert valid.sum() == batch * n_frames and valid[-K.CLUSTER * K.TILE_ROWS:].any()
    assert np.all(frame[valid] + 3 < nb)
    if (batch, samples) == (128, 128_000):
        assert n == 254 and round(1 - valid.mean(), 3) == 0.012


@pytest.mark.parametrize("batch,samples", [(128, 128_000), (5, 127_700), (3, 32_000)])
def test_work_counts_the_function_and_the_tiling_apart(batch, samples):
    """The bound's operations are the function's (each frame's DFT against
    the table's bins, one multiply-add per filterbank nonzero); the bands'
    overlap, the rows that start no frame and the groups of 4 bins come on
    top."""
    c = K.StripMelKernel().constants(CFG, 32_000, torch.device("cpu"))
    fb = TM.strip_filterbank(TM.config_filterbank(CFG, 32_000))
    nb, n_frames = cuda_melspec.geometry(samples, CFG)
    w = K.work(c, CFG, batch, samples)
    assert w["dft_min"] == 2 * batch * n_frames * 2048 * 2 * fb.shape[0]
    assert w["mel_min"] == 2 * batch * n_frames * np.count_nonzero(fb)
    assert w["dft"] == 2 * K.tiles(batch, nb, n_frames) * K.TILE_ROWS * 7 * 256 * 2048
    assert w["dft"] > w["dft_min"] and 1.0 <= w["mel"] / w["mel_min"] < 1.1
    if (batch, samples) == (128, 128_000):  # the figures chip_smoke prints
        assert np.count_nonzero(fb) == 1514
        assert (round(w["dft_min"] / 1e9, 2), round(w["dft"] / 1e9, 2)) == (202.13, 238.64)


SHAPES = [(1, 128_000), (2, 32_000), (3, 127_700), (2, 1_100)]


@functools.lru_cache(maxsize=None)
def _emulated(batch, samples, norm):
    """(waveforms, the emulation's output), shared by the two comparisons."""
    waves = _waves(batch, samples, seed=41)
    cfg = SpectrogramConfig(mel_norm=norm)
    return waves, emulate_kernel(torch.from_numpy(waves), cfg)


@pytest.mark.parametrize("norm", [None, "slaney"])
@pytest.mark.parametrize("batch,samples", SHAPES)
def test_tiling_matches_plain_version(batch, samples, norm):
    waves, got = _emulated(batch, samples, norm)
    ref = TM.log_mel_strip(torch.from_numpy(waves), SpectrogramConfig(mel_norm=norm))
    assert got.shape == ref.shape == (batch, 128, 1 + samples // 512)
    torch.testing.assert_close(got, ref, rtol=0, atol=TOL_Z)


@pytest.mark.parametrize("norm", [None, "slaney"])
@pytest.mark.parametrize("batch,samples", SHAPES)
def test_tiling_matches_pallas_kernel(batch, samples, norm):
    waves, got = _emulated(batch, samples, norm)
    ref = fused_log_mel(jnp.asarray(waves), SpectrogramConfig(mel_norm=norm), interpret=True)
    ref = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=TOL_Z)


def test_tiling_at_a_band_edge_matches_plain_version():
    """96 mels: mels end at local bin 127 of their band, the last column
    pair of the band's 256."""
    cfg = SpectrogramConfig(mel_norm="slaney", n_mels=96)
    x = torch.from_numpy(_waves(2, 32_000, seed=42))
    got = emulate_kernel(x, cfg)
    ref = TM.log_mel_strip(x, cfg)
    assert got.shape == (2, 96, 63)
    torch.testing.assert_close(got, ref, rtol=0, atol=TOL_Z)
