"""Element-wise bounds for the port's parity checks against the JAX
package, derived from a float64 evaluation of the function both compute.

Both packages compute in float32, and float32 sums depend on their order:
the vector width the CPU's instruction set gives XLA or oneDNN, or the way
torch's threads split a reduction. A fixed tolerance cannot tell a change
of CPU from a drift of the port. The bounds here hold for any order: each
package is held to a float64 evaluation of the same function on the same
rounded operands, within the float32 rounding that the function's own
sums allow (Higham, Accuracy and Stability of Numerical Algorithms, 2nd
ed., §3.1: n roundings in a row move a value by at most γ_n = n·u/(1 − n·u)
of the sum of its terms' magnitudes, u = 2^-24).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

U = 2.0 ** -24  # float32 unit roundoff
AMIN = 1e-10    # the power floor of both packages' dB
LAMBDA = 7.0    # the probabilistic bound's confidence (see gamma_prob)


def gamma(n):
    """γ_n = n·u / (1 − n·u): the relative bound on n float32 roundings in
    a row, whatever their order (a sum of n + 1 exact terms, for one)."""
    n = np.asarray(n, np.float64)
    return n * U / (1.0 - n * U)


def gamma_prob(n, lam=LAMBDA):
    """γ̃_n(λ) = exp(λ·√n·u + n·u²/(1 − u)) − 1: the bound on a sum of n
    terms that holds with probability at least 1 − 2n·exp(−λ²(1 − u)²/2)
    when the roundings are independent and of mean zero (Higham and Mary,
    SIAM J. Sci. Comput. 41(5), 2019, Theorem 2.4): 1 − 1.5e-6 at λ = 7 and
    n = 32,128. Used only for the standardize's two reductions over a whole
    window, where γ_n (1.9e-3 at that n) would exceed every other term a
    hundredfold."""
    n = np.asarray(n, np.float64)
    return np.expm1(lam * np.sqrt(n) * U + n * U * U / (1.0 - U))


def assert_within(got, want, bound, err_msg=""):
    """|got − want| ≤ bound, element by element (bound broadcasts); the
    message names the worst element and its ratio to the bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    bound = np.broadcast_to(np.asarray(bound, np.float64), d.shape)
    bad = ~(d <= bound)
    if bad.any():
        ratio = np.where(bound > 0, d / np.where(bound > 0, bound, 1), np.inf)
        i = np.unravel_index(int(np.argmax(np.where(bad, ratio, -1))), d.shape)
        raise AssertionError(
            f"{err_msg}: {int(bad.sum())} of {d.size} elements beyond the bound; worst at "
            f"{tuple(int(j) for j in i)}: got {got[i]!r}, want {want[i]!r}, "
            f"|d| {d[i]!r} > bound {bound[i]!r}")


# ---------------------------------------------------------------------------
# The factored log-mel with bf16 DFT operands
# ---------------------------------------------------------------------------

def _bf16(a) -> np.ndarray:
    """Round to bf16 (nearest, ties to even), back as float64."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


@dataclass
class LogMelTruth:
    """The factored log-mel of ``waveforms`` in float64 on the bf16-rounded
    operands, with the float32 bound of each of its cells.

    ``db`` [B, n_mels, n_frames] is the clamped dB plane, ``z`` its
    standardize,
    ``db_bound`` the bound on a float32 evaluation's dB plane.
    ``standardized`` gives what a float32 evaluation's z-scores are held
    to, from its own dB plane.
    """

    db: np.ndarray
    z: np.ndarray
    db_bound: np.ndarray
    eps: float

    def standardized(self, db) -> tuple:
        """(want, bound) for the z-scores of a float32 evaluation whose dB
        plane is ``db``: |z − want| ≤ bound, cell by cell.

        Its z-scores are (d − μ) / (σ + eps) with its own window mean μ and
        σ, which average every cell's error, the cells below the float32
        floor too, whose own bound is the clamp interval and says nothing
        of their average. So ``want`` is the truth's dB plane standardized
        in float64 with the statistics of ``db`` itself, each cell's error
        first clipped to its own bound (a plane within its bound is taken
        as it is; one beyond it moves the mean and σ no further than a
        plane within it could). What is left is each cell's own error,
        db_bound / (σ + eps), and the rounding of the float32 standardize:
        γ̃_N·mean|d| for the mean, (γ̃_N + γ_6)·σ for σ (the squares, the
        division and the square root), and 4u·(|z| + 1) for the
        subtraction and the division of each cell."""
        db = self.db + np.clip(np.asarray(db, np.float64) - self.db, -self.db_bound,
                               self.db_bound)
        dims = (1, 2)
        n = math.prod(db.shape[1:])
        mu = db.mean(dims, keepdims=True)
        sd = db.std(dims, ddof=1, keepdims=True)
        want = (self.db - mu) / (sd + self.eps)
        r_mu = gamma_prob(n) * np.abs(db).mean(dims, keepdims=True) + U * np.abs(mu)
        r_sd = (gamma_prob(n) + gamma(6)) * sd + r_mu ** 2 / sd
        az = np.abs(want)
        bound = (self.db_bound + r_mu + az * r_sd) / (sd + self.eps) + 4 * U * (az + 1.0)
        return want, bound


def log_mel_truth(waveforms: np.ndarray, cfg, sample_rate: int = 32_000) -> LogMelTruth:
    """The float64 truth of ``melspec.log_mel_factored(dft_dtype=bf16)`` and
    of the reference's Pallas kernel, which compute one function: the
    centre-padded waveform's hop blocks and the block-DFT basis rounded to
    bf16, each block's DFT, the frame combine with the hop phases, the
    periodic Hann as the 3-tap conv in frequency, |X|², the float32 Slaney
    filterbank, 10·log10(max(·, 1e-10)) and the top_db clamp.

    The bound on a float32 evaluation's dB, cell by cell:
    - W, the windowed spectrum: every product of two bf16 values is exact in
      float32; a path from an input to W meets hop − 1 additions of the
      block DFT, at most 9 roundings in the frame combine (a product and two
      additions in each of 4 steps, the first step's result added three more
      times) and 2 in the Hann taps (the 0.5 and 0.25 scalings are exact):
      |ΔW| ≤ γ_{hop+16}·M, M the same linear map evaluated on the absolute
      values of the operands and of every coefficient;
    - the power p = W_re² + W_im²: |Δp| ≤ 2(|W_re|e_re + |W_im|e_im)
      + e_re² + e_im² + γ_2·((|W_re| + e_re)² + (|W_im| + e_im)²);
    - the mel sum of the nnz non-zero filterbank terms (the products round
      too; an added zero does not): |Δmel| ≤ Σ fb·Δp + γ_nnz·Σ fb·(p + Δp);
    - dB: the interval 10·log10(max(mel ∓ Δmel, 1e-10)), widened by 8 ulps
      of the dB value for log10 and the scaling;
    - the clamp: the window's peak moves by at most the widest the interval
      of its highest cells reaches, and the clamped interval of each cell
      is max(interval, peak − top_db ± that), the subtraction of top_db
      rounding once more.
    The bound is the larger distance from the truth to the clamped
    interval's ends. Where the interval reaches the clamp (the cells below
    the float32 floor), it is no finer than the clamp."""
    from synthetic_audio_detection_tpu_torch.ops import melspec as TM

    fb = TM.config_filterbank(cfg, sample_rate)
    n_cols = TM.significant_bins(fb)
    fb = fb[:n_cols].astype(np.float64)
    blocks, n_frames = TM.factored_blocks(torch.as_tensor(waveforms, dtype=torch.float32), cfg)
    blk = _bf16(blocks.numpy())
    hop, k4, nraw = cfg.hop_length, cfg.n_fft // cfg.hop_length, n_cols + 1
    cos_m, sin_m = TM._dft_matrices(cfg.n_fft, nraw)
    c, s = _bf16(cos_m[:hop]), _bf16(sin_m[:hop])
    y_re, y_im = blk @ c, blk @ s
    m_re, m_im = np.abs(blk) @ np.abs(c), np.abs(blk) @ np.abs(s)
    a, b = (p.astype(np.float64) for p in TM.hop_block_phases(cfg.n_fft, hop, nraw))

    def frames(re, im, sign):  # Σ_i c_i·Y[t + i], or its absolute-value twin
        o_re = sum(a[i] * re[:, i:i + n_frames] - sign * b[i] * im[:, i:i + n_frames]
                   for i in range(k4))
        o_im = sum(a[i] * im[:, i:i + n_frames] + b[i] * re[:, i:i + n_frames]
                   for i in range(k4))
        return o_re, o_im

    def hann(re, im, sign):  # 0.5·X[f] − 0.25·(X[f−1] + X[f+1]), X[−1] = conj(X[1])
        r_re = np.concatenate([re[..., 1:2], re[..., :n_cols - 1]], -1)
        r_im = np.concatenate([-sign * im[..., 1:2], im[..., :n_cols - 1]], -1)
        return (0.5 * re[..., :n_cols] - sign * 0.25 * (r_re + re[..., 1:n_cols + 1]),
                0.5 * im[..., :n_cols] - sign * 0.25 * (r_im + im[..., 1:n_cols + 1]))

    w_re, w_im = hann(*frames(y_re, y_im, 1.0), 1.0)
    a, b = np.abs(a), np.abs(b)
    e_re, e_im = (gamma(hop + 16) * m for m in hann(*frames(m_re, m_im, -1.0), -1.0))
    p = w_re ** 2 + w_im ** 2
    e_p = (2 * (np.abs(w_re) * e_re + np.abs(w_im) * e_im) + e_re ** 2 + e_im ** 2
           + gamma(2) * ((np.abs(w_re) + e_re) ** 2 + (np.abs(w_im) + e_im) ** 2))
    nnz = (fb != 0).sum(0)
    mel = (p @ fb).transpose(0, 2, 1)
    e_mel = (e_p @ fb + gamma(nnz) * ((p + e_p) @ fb)).transpose(0, 2, 1)

    to_db = lambda m: 10.0 * np.log10(np.maximum(m, AMIN))  # noqa: E731
    d = to_db(mel)
    ulps = 8 * U * (np.abs(d) + 1.0)
    lo, hi = to_db(mel - e_mel) - ulps, to_db(mel + e_mel) + ulps
    dims = (1, 2)
    peak = d.max(dims, keepdims=True)
    e_peak = np.maximum(hi.max(dims, keepdims=True) - peak, peak - lo.max(dims, keepdims=True))
    floor = peak - cfg.top_db
    e_floor = e_peak + U * (np.abs(peak) + cfg.top_db)
    db = np.maximum(d, floor)
    db_bound = np.maximum(db - np.maximum(lo, floor - e_floor),
                          np.maximum(hi, floor + e_floor) - db)
    sd = db.std(dims, ddof=1, keepdims=True)
    z = (db - db.mean(dims, keepdims=True)) / (sd + cfg.eps)
    return LogMelTruth(db=db, z=z, db_bound=db_bound, eps=cfg.eps)


# ---------------------------------------------------------------------------
# A deep float32 evaluation: a train step, a network's logits
# ---------------------------------------------------------------------------

REFERENCE_MULTIPLE = 8.0


def reference_error_bound(ref, truth, scale: float, rel: float = 0.0) -> float:
    """The bound on |port − truth| for one tensor of a deep float32
    evaluation (an Adam moment of a train step, a network's logits, its
    losses): ``ref`` the reference's float32 result, ``truth`` the
    reference's float64 evaluation of the same function on the same
    inputs, ``scale`` the largest magnitude of this kind of tensor in the
    truth (all the μ of a model, say), ``rel`` the reference's typical
    relative error on this kind of tensor.

    A network is too deep for an a-priori float32 bound: these small ones
    (BatchNorm over 16 values a channel at layer4, ReLUs near zero)
    magnify rounding about a thousandfold, and the magnification belongs
    to the function, not to either package. The reference's own float32
    error on the tensor, max|ref − truth|, measures it; on a tensor of a
    few elements it can be small by chance, so it is taken no smaller than
    ``rel`` of the tensor's largest truth. Two sound float32 evaluations
    of one function differ in their error by the summation orders they
    choose, not by orders of magnitude: over the parity files, under each
    CPU setting of tests/parity_sweep.py, the port's error is at most 3.6
    times the reference's so measured (the "spread" that
    assert_within_reference returns; the add-head's head moments with XLA
    at SSE4.2). REFERENCE_MULTIPLE is twice that, rounded up to a power of
    two, so that no such check sits beyond half its bound on any of these
    CPUs. A tensor whose float64 value is zero but for rounding (the
    gradient of a Linear's bias before a BatchNorm) is rounding noise in
    both packages, of a size set by the terms that cancel in it, not by
    its own values: 8 ulps of ``scale`` bound that noise."""
    ref, truth = np.asarray(ref, np.float64), np.asarray(truth, np.float64)
    if not truth.size:
        return 8 * U * scale
    e_ref = max(float(np.abs(ref - truth).max()), rel * float(np.abs(truth).max()))
    return REFERENCE_MULTIPLE * e_ref + 8 * U * scale


def assert_within_reference(got, ref, truth, scale: float, rel: float = 0.0,
                            err_msg: str = "") -> dict:
    """|got − truth| ≤ reference_error_bound(ref, truth, scale, rel), element
    by element. → the distances behind it: ``port`` and ``reference``,
    max|got − truth| and max|ref − truth| over the truth's largest
    magnitude; ``ratio``, the port's over the bound; ``spread``, the port's
    over the bound's share per REFERENCE_MULTIPLE (the multiple of the
    reference's error that the port needs)."""
    got, ref, truth = (np.asarray(a, np.float64) for a in (got, ref, truth))
    bound = reference_error_bound(ref, truth, scale, rel)
    assert_within(got, truth, bound, err_msg)
    if not truth.size:
        return {"port": 0.0, "reference": 0.0, "ratio": 0.0, "spread": 0.0}
    top = max(float(np.abs(truth).max()), 1e-300)
    e_port = float(np.abs(got - truth).max())
    return {"port": e_port / top, "reference": float(np.abs(ref - truth).max()) / top,
            "ratio": e_port / bound, "spread": REFERENCE_MULTIPLE * e_port / bound}


def assert_loss_within(loss, truth_loss, logits, truth_logits, err_msg: str = "loss"):
    """A weighted mean of two-class cross-entropies against its float64
    truth, within what the checked logits' own error explains: each row's
    loss has the gradient softmax − onehot, whose entries' magnitudes sum
    to at most 2, and the mean's weights sum to 1, so the loss moves by at
    most twice the logits' largest move, 2·max|logits − truth_logits|; its
    own float32 evaluation (the max subtracted, two exponentials, their
    sum, the log, the label's logit, the weighted sum of the rows and the
    division) rounds about ten times, each within u of max|logit| + |loss|:
    16u of that."""
    logits, truth_logits = (np.asarray(a, np.float64) for a in (logits, truth_logits))
    bound = (2 * float(np.abs(logits - truth_logits).max())
             + 16 * U * (float(np.abs(truth_logits).max()) + abs(float(truth_loss))))
    assert_within(float(loss), float(truth_loss), bound, err_msg)


def assert_moments_within(port, ref, truth) -> list:
    """The port's Adam moments (``port`` = (μ, ν), dicts by parameter name,
    arrays or tensors) against the float64 truth, each tensor within
    reference_error_bound of the reference's float32 error on it: the
    scale that of all the model's μ, or ν; ``rel`` the median over the
    model's tensors of the reference's error over the tensor's largest
    truth. → one row a tensor: assert_within_reference's distances, with
    ``moment`` ("mu", "nu"), ``name`` and ``top``, the truth's largest
    magnitude over ``scale``."""
    rows = []
    for moment, got, want, true in zip(("mu", "nu"), port, ref, truth):
        true = {k: np.asarray(v, np.float64) for k, v in true.items()}
        want = {k: np.asarray(want[k], np.float64) for k in true}
        scale = max(float(np.abs(v).max()) for v in true.values() if v.size)
        rel = float(np.median([np.abs(want[k] - t).max() / np.abs(t).max()
                               for k, t in true.items() if t.size and np.abs(t).max() > 0]))
        for k, t in true.items():
            row = assert_within_reference(np.asarray(got[k]), want[k], t, scale, rel, k)
            top = float(np.abs(t).max()) / scale if t.size else 0.0
            rows.append(dict(row, moment=moment, name=k, top=top))
    return rows


# ---------------------------------------------------------------------------
# The windowed-sinc low-pass kernels of the waveform augmentation
# ---------------------------------------------------------------------------

def lowpass_truth(cutoffs_hz, taps: int, sample_rate: int) -> tuple:
    """(want, bound): h[n] = 2fc·sinc(2fc(n − c))·hann(n) / Σh in float64
    from the float32 cutoffs, and the bound on a float32 evaluation, cell
    by cell, to first order in u:
    - t = 2fc·(n − c): fc = cutoff / rate and the product round, |Δt| ≤ 2u|t|;
    - sinc(t) = sin(πt) / (πt): π and πt round once more, so the sine's
      argument is off by 4u·π|t|, its value by that, and the sine and the
      division add u each: |Δsinc| ≤ 4u·|cos πt| + 2u·|sinc| (exact at 0);
    - hann(k) = 0.5 − 0.5·cos(2πk / (taps − 1)): the argument is off by 3u
      of itself (at most 2π), the cosine and the subtraction round:
      |Δhann| ≤ 0.5·(3u·2π + u) + u;
    - the product 2fc·sinc·hann rounds twice more: |Δh| ≤ 2fc·(|Δsinc|·hann
      + |sinc|·Δhann) + 3u|h|;
    - the sum S = Σh of taps terms: |ΔS| ≤ Σ|Δh| + γ_taps·Σ|h|;
    - h / S: |Δ| ≤ |Δh| / S + |h|·|ΔS| / S² + u·|h / S|."""
    cut = np.asarray(cutoffs_hz, np.float32).astype(np.float64)
    fc = (cut / sample_rate)[:, None]
    t = 2.0 * fc * (np.arange(taps) - (taps - 1) / 2.0)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(taps) / (taps - 1))
    sinc = np.sinc(t)
    h = 2.0 * fc * sinc * win
    s = h.sum(1, keepdims=True)
    e_sinc = np.where(t == 0, 0.0, 4 * U * np.abs(np.cos(np.pi * t)) + 2 * U * np.abs(sinc))
    e_win = 0.5 * (3 * U * 2 * np.pi + U) + U
    e_h = 2.0 * fc * (e_sinc * win + np.abs(sinc) * e_win) + 3 * U * np.abs(h)
    e_s = e_h.sum(1, keepdims=True) + gamma(taps) * np.abs(h).sum(1, keepdims=True)
    want = h / s
    return want, e_h / np.abs(s) + np.abs(h) * e_s / s ** 2 + U * np.abs(want)
