"""Word-level alignment for editing from a raw wav (PyTorch port of
voicecraft_tpu/align.py).

``energy_align`` is a dependency-free energy/VAD aligner: voiced segments
from adaptive log-energy thresholding, words spread over voiced time in
proportion to their phone counts (character counts by default).  On clean
procedural speech with exact boundaries the JAX package measured a
word-boundary error of median 35 ms / p90 97 ms
(tests/test_align_characterization.py).  It returns MFA-shaped rows
[{"Label", "Begin", "End", "Type": "words", "Source": "energy"}], the rows
``inference/editing.py:get_mask_interval`` reads.

``WhisperWordAligner`` takes word timestamps from transformers' Whisper (a
local snapshot) through its cross-attention token timestamps, and
``align_words`` prefers it when a snapshot is given.
"""

from __future__ import annotations

import logging
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)


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
        log.warning(
            "energy-aligner timestamps: widening edit margins %.3f/%.3f -> "
            "%.3f/%.3f s (p90 boundary error %.0f ms; pass an MFA CSV for "
            "tighter spans)", left, right, wl, wr, ENERGY_P90_SEC * 1000)
        return wl, wr, True
    return left, right, False


# ==============================================================================
# Whisper cross-attention word timestamps (local snapshot only)
# ==============================================================================

def merge_word_pieces(pieces: Sequence[str], times: Sequence[float]
                      ) -> List[Dict]:
    """The JAX aligner's merge rule (voicecraft_tpu/align.py:193-211):
    decoded token ``pieces`` with their timestamps into word rows, skipping
    empty and ``<|...|>`` pieces and starting a word at a piece with a
    leading space."""
    rows: List[Dict] = []
    cur, t0, t1 = "", 0.0, 0.0
    for piece, t in zip(pieces, times):
        if not piece or piece.startswith("<|"):
            continue
        if piece.startswith(" ") and cur:
            rows.append({"Label": cur.strip(), "Begin": t0, "End": t1,
                         "Type": "words"})
            cur, t0 = "", t
        if not cur:
            t0 = t
        cur += piece
        t1 = t
    if cur.strip():
        rows.append({"Label": cur.strip(), "Begin": t0, "End": t1,
                     "Type": "words"})
    return rows


class WhisperWordAligner:
    """Word timestamps from transformers' Whisper ``return_token_timestamps``
    (DTW over the cross-attention of the snapshot's alignment heads, what
    whisperx builds on), the model on ``device``.  Needs a local snapshot
    dir (e.g. openai/whisper-base) whose generation config names its
    ``alignment_heads``."""

    def __init__(self, model_path: str, device="cuda"):
        from transformers import (WhisperForConditionalGeneration,
                                  WhisperProcessor)
        self.device = torch.device(device)
        self.processor = WhisperProcessor.from_pretrained(model_path)
        self.model = WhisperForConditionalGeneration.from_pretrained(
            model_path).to(self.device).eval()

    def align(self, wav: np.ndarray, sr: int = 16000) -> List[Dict]:
        """The word rows of ``wav``'s transcript."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        inputs = self.processor(wav, sampling_rate=sr, return_tensors="pt")
        with torch.no_grad():
            out = self.model.generate(
                inputs.input_features.to(self.device),
                return_token_timestamps=True, return_dict_in_generate=True)
        # a ModelOutput or (transformers 4.57) a plain dict: both index
        ids = out["sequences"][0].tolist()
        decode = self.processor.tokenizer.decode
        return merge_word_pieces([decode([i]) for i in ids],
                                 out["token_timestamps"][0].tolist())


@lru_cache(maxsize=2)
def make_aligner(model_path: str, device="cuda") -> WhisperWordAligner:
    """The aligner of ``model_path`` on ``device``, memoized (a server
    aligns every /edit)."""
    return WhisperWordAligner(model_path, device)


# ==============================================================================
# dispatcher
# ==============================================================================

def align_words(wav: np.ndarray, sr: int, transcript: str,
                asr_model_path: Optional[str] = None,
                weights: Optional[Sequence[float]] = None,
                device="cuda") -> List[Dict]:
    """Word alignment rows for ``transcript`` against ``wav``: Whisper's
    (``asr_model_path``, on ``device``) when the snapshot loads and yields
    rows, else the dependency-free energy aligner's, so that editing never
    needs an external MFA CSV (reference predict.py:209-215).  Only a
    snapshot that does not load (OSError or ValueError from
    ``from_pretrained``) or rows that Whisper does not yield fall back, with
    a warning; an error inside the aligner propagates."""
    if asr_model_path:
        try:
            aligner = make_aligner(asr_model_path, device)
        except (OSError, ValueError) as e:
            log.warning("the Whisper snapshot %s did not load (%s): word "
                        "rows from the energy aligner", asr_model_path, e)
        else:
            rows = aligner.align(wav, sr)
            if rows:
                return rows
            log.warning("Whisper (%s) yielded no words: word rows from the "
                        "energy aligner", asr_model_path)
    return energy_align(wav, sr, transcript.split(), weights=weights)
