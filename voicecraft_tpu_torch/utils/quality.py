"""ASR-free audio quality metrics: log-mel distance and MCD, DTW-aligned
(the port's copy of voicecraft_tpu/utils/quality.py, held equal to it by
tests/test_torch_quality.py).

The reference's reason to exist is output quality (README.md:5-8), but its
quality evidence is human listening + WER over published checkpoints —
neither available in a zero-egress environment.  These metrics compare
generated audio against ground-truth audio directly in the spectral
domain, so the procedural corpus (whose transcripts have exact ground-truth
waveforms) yields a quality number for every decode mode without any ASR
model:

* ``log_mel_distance`` — mean L2 distance between log-mel frames along the
  DTW path (dB-scale spectral envelope mismatch; robust to small timing
  drift, which TTS legitimately has).
* ``mcd`` — mel-cepstral distortion (the standard TTS objective metric),
  DTW-aligned, c1..c13, with the usual 10*sqrt(2)/ln(10) constant.
* ``duration_ratio`` — generated / reference duration (catches early EOG
  and runaway generation, which spectral metrics forgive).

Everything is plain numpy (no librosa/scipy): framing + rfft STFT, an
HTK-style mel filterbank, a DCT-II, and an O(T1*T2) vectorised DTW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# ==============================================================================
# STFT + mel
# ==============================================================================

def _frame(wav: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """[T] -> [n_frames, n_fft], reflection-padded by n_fft//2 (librosa
    'center' convention so frame t is centred at t*hop)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    pad = n_fft // 2
    wav = np.pad(wav, (pad, pad), mode="reflect" if len(wav) > pad
                 else "constant")
    n = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(max(n, 1))[:, None]
    return wav[np.minimum(idx, len(wav) - 1)]


def stft_power(wav: np.ndarray, n_fft: int = 1024, hop: int = 256
               ) -> np.ndarray:
    """Power spectrogram [n_frames, n_fft//2+1] with a Hann window."""
    frames = _frame(wav, n_fft, hop)
    win = np.hanning(n_fft).astype(np.float32)
    spec = np.fft.rfft(frames * win, axis=1)
    return (spec.real ** 2 + spec.imag ** 2).astype(np.float32)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular HTK-mel filters."""
    fmax = fmax or sr / 2.0
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                 n_mels + 2))
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)), np.float32)
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (bins - lo) / max(c - lo, 1e-9)
        down = (hi - bins) / max(hi - c, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def log_mel(wav: np.ndarray, sr: int, n_fft: int = 1024, hop: int = 256,
            n_mels: int = 80) -> np.ndarray:
    """[n_frames, n_mels] log10 mel power."""
    p = stft_power(wav, n_fft, hop)
    fb = mel_filterbank(sr, n_fft, n_mels)
    return np.log10(np.maximum(p @ fb.T, 1e-10)).astype(np.float32)


def _dct2(x: np.ndarray, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II over the last axis, first ``n_out`` coeffs."""
    n = x.shape[-1]
    k = np.arange(n_out)[:, None]
    basis = np.cos(np.pi * k * (2 * np.arange(n)[None, :] + 1) / (2 * n))
    basis *= np.sqrt(2.0 / n)
    basis[0] /= np.sqrt(2.0)
    return (x @ basis.T).astype(np.float32)


def mel_cepstra(wav: np.ndarray, sr: int, n_mfc: int = 14,
                n_mels: int = 80) -> np.ndarray:
    """[n_frames, n_mfc] mel-cepstra (c0..c{n_mfc-1}) from ln-mel power."""
    lm = log_mel(wav, sr, n_mels=n_mels) * np.log(10.0)   # ln scale
    return _dct2(lm, n_mfc)


# ==============================================================================
# DTW
# ==============================================================================

def dtw_path_cost(dist: np.ndarray) -> Tuple[float, int]:
    """Classic DTW over a [T1, T2] frame-distance matrix.

    Returns (mean distance along the optimal path, path length).
    Anti-diagonal wavefront: each of the T1+T2-1 diagonals is one
    vectorised numpy step (cell (i, j=d-i) depends only on diagonals d-1
    for up/left and d-2 for the diagonal move), so utterance-scale inputs
    (a few thousand frames) cost milliseconds, not a Python double loop.
    """
    t1, t2 = dist.shape
    assert t1 > 0 and t2 > 0
    INF = np.float64(np.inf)
    # diagonals indexed by row i (length t1); acc = accumulated cost,
    # stp = path length, at diagonal d (j = d - i)
    prev2 = np.full(t1, INF)        # d-2
    prev = np.full(t1, INF)         # d-1
    sprev2 = np.zeros(t1, np.int64)
    sprev = np.zeros(t1, np.int64)
    for d in range(t1 + t2 - 1):
        i0, i1 = max(0, d - (t2 - 1)), min(t1 - 1, d)
        ii = np.arange(i0, i1 + 1)
        row = dist[ii, d - ii].astype(np.float64)
        cur = np.full(t1, INF)
        scur = np.zeros(t1, np.int64)
        if d == 0:
            cur[0] = row[0]
            scur[0] = 1
        else:
            # candidates: up = (i-1, j) on d-1; left = (i, j-1) on d-1;
            # diag = (i-1, j-1) on d-2
            up = np.where(ii - 1 >= 0, prev[np.maximum(ii - 1, 0)], INF)
            left = prev[ii]
            diag = np.where(ii - 1 >= 0, prev2[np.maximum(ii - 1, 0)], INF)
            s_up = np.where(ii - 1 >= 0, sprev[np.maximum(ii - 1, 0)], 0)
            s_left = sprev[ii]
            s_diag = np.where(ii - 1 >= 0, sprev2[np.maximum(ii - 1, 0)], 0)
            cand = np.stack([diag, up, left])          # diag preferred
            scand = np.stack([s_diag, s_up, s_left])
            pick = np.argmin(cand, axis=0)
            base = cand[pick, np.arange(len(ii))]
            sbase = scand[pick, np.arange(len(ii))]
            cur[ii] = base + row
            scur[ii] = sbase + 1
        prev2, prev = prev, cur
        sprev2, sprev = sprev, scur
    n = int(sprev[t1 - 1])
    return float(prev[t1 - 1] / max(n, 1)), n


def _pair_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[T1, T2] Euclidean distances between frame sets [T1,D], [T2,D]."""
    aa = (a ** 2).sum(1)[:, None]
    bb = (b ** 2).sum(1)[None, :]
    d2 = np.maximum(aa + bb - 2.0 * (a @ b.T), 0.0)
    return np.sqrt(d2)


# ==============================================================================
# metrics
# ==============================================================================

def log_mel_distance(ref: np.ndarray, hyp: np.ndarray, sr: int,
                     n_mels: int = 80) -> float:
    """Mean L2 log10-mel frame distance along the DTW path (lower=better)."""
    mr, mh = log_mel(ref, sr, n_mels=n_mels), log_mel(hyp, sr, n_mels=n_mels)
    cost, _ = dtw_path_cost(_pair_dist(mr, mh))
    return cost


_MCD_CONST = 10.0 * np.sqrt(2.0) / np.log(10.0)


def mcd(ref: np.ndarray, hyp: np.ndarray, sr: int, n_mfc: int = 14
        ) -> float:
    """Mel-cepstral distortion in dB (c1..c{n_mfc-1}, DTW-aligned;
    lower=better; ~0 for identical audio, typically 4-8 dB for decent TTS
    on real speech)."""
    cr = mel_cepstra(ref, sr, n_mfc=n_mfc)[:, 1:]
    ch = mel_cepstra(hyp, sr, n_mfc=n_mfc)[:, 1:]
    cost, _ = dtw_path_cost(_pair_dist(cr, ch))
    return float(_MCD_CONST * cost)


def duration_ratio(ref: np.ndarray, hyp: np.ndarray) -> float:
    """len(hyp)/len(ref) — catches early-EOG / runaway generation."""
    return float(len(np.asarray(hyp).reshape(-1))
                 / max(len(np.asarray(ref).reshape(-1)), 1))
