"""Word-level alignment for editing from a raw wav (PyTorch port of
voicecraft_tpu/align.py, the energy path).

``energy_align`` is a dependency-free energy/VAD aligner: voiced segments
from adaptive log-energy thresholding, words spread over voiced time in
proportion to their phone counts (character counts by default).  On clean
procedural speech with exact boundaries the JAX package measured a
word-boundary error of median 35 ms / p90 97 ms
(tests/test_align_characterization.py).  It returns MFA-shaped rows
[{"Label", "Begin", "End", "Type": "words", "Source": "energy"}], the rows
``inference/editing.py:get_mask_interval`` reads.

The JAX package's Whisper aligner (a local transformers snapshot) is not
yet ported: ``align_words`` refuses an ASR model instead of falling back.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np


# ==============================================================================
# energy VAD
# ==============================================================================

def frame_energy_db(wav: np.ndarray, sr: int, win_s: float = 0.025,
                    hop_s: float = 0.010) -> np.ndarray:
    """Log frame energy (dB) over [T] samples; 25 ms windows, 10 ms hop."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    win = max(int(win_s * sr), 1)
    hop = max(int(hop_s * sr), 1)
    n = max(1 + (len(wav) - win) // hop, 1)
    idx = np.arange(win)[None, :] + hop * np.arange(n)[:, None]
    idx = np.minimum(idx, len(wav) - 1)
    frames = wav[idx]
    e = np.mean(frames ** 2, axis=1)
    return 10.0 * np.log10(np.maximum(e, 1e-12))


def voiced_segments(wav: np.ndarray, sr: int, hop_s: float = 0.010,
                    min_gap_s: float = 0.12, min_seg_s: float = 0.06
                    ) -> List[tuple]:
    """Adaptive-threshold VAD -> [(start_sec, end_sec)] voiced spans.

    The threshold sits between the noise floor (5th percentile) and the
    speech level (95th); short gaps are bridged, short blips dropped."""
    e = frame_energy_db(wav, sr, hop_s=hop_s)
    lo, hi = np.percentile(e, 5.0), np.percentile(e, 95.0)
    thr = max(lo + 0.25 * (hi - lo), hi - 35.0)
    voiced = e > thr

    max_gap = int(round(min_gap_s / hop_s))
    segs = []
    start = None
    gap = 0
    for i, v in enumerate(voiced):
        if v:
            if start is None:
                start = i
            gap = 0
        elif start is not None:
            gap += 1
            if gap > max_gap:
                segs.append((start, i - gap + 1))
                start, gap = None, 0
    if start is not None:
        segs.append((start, len(voiced) - gap))

    return [(s * hop_s, t * hop_s) for s, t in segs
            if (t - s) * hop_s >= min_seg_s]


# ==============================================================================
# proportional word alignment over voiced time
# ==============================================================================

def _voiced_time_to_abs(segs: Sequence[tuple], vt: float) -> float:
    """Map an offset into concatenated voiced time to absolute seconds."""
    for s, t in segs:
        d = t - s
        if vt <= d or (s, t) == segs[-1]:
            return s + min(vt, d)
        vt -= d
    return segs[-1][1]


def energy_align(wav: np.ndarray, sr: int, words: Sequence[str],
                 weights: Optional[Sequence[float]] = None) -> List[Dict]:
    """Align ``words`` to ``wav`` by proportional allocation over voiced
    time.  ``weights`` default to per-word character counts (a phone-count
    proxy).  Returns MFA-shaped rows."""
    words = [w for w in words if w]
    assert words, "no words to align"
    dur = len(np.asarray(wav).reshape(-1)) / sr
    segs = voiced_segments(wav, sr) or [(0.0, dur)]
    if weights is None:
        weights = [max(len(w), 1) for w in words]
    weights = np.asarray(weights, np.float64)
    assert len(weights) == len(words) and (weights > 0).all()

    total_voiced = sum(t - s for s, t in segs)
    cum = np.concatenate([[0.0], np.cumsum(weights)]) / weights.sum()
    rows = []
    for i, w in enumerate(words):
        t0 = _voiced_time_to_abs(segs, cum[i] * total_voiced)
        t1 = _voiced_time_to_abs(segs, cum[i + 1] * total_voiced)
        rows.append({"Label": w, "Begin": round(float(t0), 4),
                     "End": round(float(t1), 4), "Type": "words",
                     "Source": "energy"})
    return rows


# the energy aligner's p90 word-boundary error on clean speech (above)
ENERGY_P90_SEC = 0.097


def widen_margins_for_aligner(rows: Sequence[Dict], left: float,
                              right: float) -> tuple:
    """Floor the edit margins at the energy aligner's p90 boundary error
    when ``rows`` came from it (``Source == "energy"``), so that word edges
    are not clipped; MFA rows leave them as they are.  Returns (left,
    right, widened) and logs a warning when it widens."""
    if not any(r.get("Source") == "energy" for r in rows):
        return left, right, False
    wl, wr = max(left, ENERGY_P90_SEC), max(right, ENERGY_P90_SEC)
    if (wl, wr) != (left, right):
        logging.getLogger(__name__).warning(
            "energy-aligner timestamps: widening edit margins %.3f/%.3f -> "
            "%.3f/%.3f s (p90 boundary error %.0f ms; pass an MFA CSV for "
            "tighter spans)", left, right, wl, wr, ENERGY_P90_SEC * 1000)
        return wl, wr, True
    return left, right, False


def align_words(wav: np.ndarray, sr: int, transcript: str,
                asr_model_path: Optional[str] = None,
                weights: Optional[Sequence[float]] = None) -> List[Dict]:
    """Word alignment rows for ``transcript`` against ``wav`` from the
    energy aligner.  An ASR model (the JAX package's Whisper aligner) is not
    yet ported and is refused."""
    if asr_model_path:
        raise NotImplementedError("the Whisper aligner (asr_model_path) is "
                                  "not yet ported to voicecraft_tpu_torch")
    return energy_align(wav, sr, transcript.split(), weights=weights)
