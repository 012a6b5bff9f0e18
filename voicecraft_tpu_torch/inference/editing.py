"""Multi-span speech editing (PyTorch port of
voicecraft_tpu/inference/editing.py): the decode of the masked spans (plain
or speculative) and their splice, the word diff between transcripts and
the alignment-to-seconds conversion the editing CLI uses.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data import spans
from ..models.voicecraft import SamplingConfig, VoiceCraft
from .tts import check_codes, run_decode


def inference_edit(model: VoiceCraft, x_tokens: np.ndarray,
                   y_codes: np.ndarray,
                   mask_intervals: Sequence[Tuple[int, int]],
                   scfg: SamplingConfig = SamplingConfig(), seed: int = 1,
                   gen_max: Optional[int] = None, fused_ffn: bool = False,
                   stats: Optional[dict] = None, spec: int = 0) -> np.ndarray:
    """Regenerate the masked codec-frame intervals of ``y_codes`` [K, T]
    for the phoneme sequence ``x_tokens`` of the edited transcript.
    ``fused_ffn`` runs the decode-step FFN through the fused kernel.
    ``spec`` = tau >= 2 decodes speculatively (make_spec_edit_loop; the
    model needs tau - 1 MTP head groups): greedy output equals the plain
    loop's in f32, sampled output is keyed per token index (the same for
    every tau).  ``stats`` receives run_decode's counts and the frames
    generated for each span (``span_frames``).

    Returns the kept spans and the generated ones spliced in order [K, T']."""
    cfg = model.cfg
    check_codes(cfg, y_codes)
    if cfg.special_first:
        y_codes = y_codes + cfg.n_special
    mask_intervals = sorted((int(s), int(e)) for s, e in mask_intervals)
    prefix, queue_ids = spans.compose_edit_prefix(y_codes, mask_intervals, cfg)
    m = len(mask_intervals)
    gen = run_decode(model, is_tts=False, x_tokens=x_tokens, prefix=prefix,
                     queue_mask_ids=queue_ids, n_spans=m, scfg=scfg,
                     seed=seed, gen_max=gen_max, fused_ffn=fused_ffn,
                     stats=stats, spec=spec)
    if stats is not None:
        stats["span_frames"] = [g.shape[1] for g in gen]

    starts = [s for s, _ in mask_intervals]
    ends = [e for _, e in mask_intervals]
    non_mask = list(zip([0] + ends, starts + [y_codes.shape[1]]))
    parts = []
    for j, (lo, hi) in enumerate(non_mask[:-1]):
        parts.append(y_codes[:, lo:hi])
        parts.append(gen[j])
    lo, hi = non_mask[-1]
    parts.append(y_codes[:, lo:hi])
    res = np.concatenate(parts, axis=1)
    if cfg.special_first:
        res = res - cfg.n_special
    return res


# ---- edit span computation ------------------------------------------------------

def fractional_edit_span(n_frames: int, f0: float, f1: float,
                         min_len: int = 4) -> Optional[Tuple[int, int]]:
    """Frame interval covering the (f0, f1) fraction of an utterance,
    clamped to [1, n_frames - 1]; None when the clamped span is shorter
    than ``min_len`` frames."""
    s = max(1, int(n_frames * f0))
    e = min(n_frames - 1, int(n_frames * f1))
    return (s, e) if e - s >= min_len else None


def get_span(orig: str, new: str, editType: str) -> Tuple[List[int], List[int]]:
    """Word-level diff between transcripts -> (orig_span, new_span)
    word-index intervals.  The edited block is contiguous; deletion and
    insertion spans start at the first diverging word (the changed block
    must not reach the end of the shorter transcript); substitution spans
    run from the first to the last diverging word."""
    orig_list = orig.split(" ")
    new_list = new.split(" ")

    if editType == "deletion":
        assert len(orig_list) > len(new_list), (orig, new)
        diff = len(orig_list) - len(new_list)
        for i, (o, n) in enumerate(zip(orig_list, new_list)):
            if o != n:
                return [i, i + diff - 1], [i - 1, i]
    elif editType == "insertion":
        assert len(new_list) > len(orig_list), (orig, new)
        diff = len(new_list) - len(orig_list)
        for i, (o, n) in enumerate(zip(orig_list, new_list)):
            if o != n:
                return [i - 1, i], [i, i + diff - 1]
    elif editType == "substitution":
        start = next((i for i, (o, n) in enumerate(zip(orig_list, new_list))
                      if o != n), None)
        assert start is not None, (orig, new)
        for j, (o, n) in enumerate(zip(orig_list[::-1], new_list[::-1])):
            if o != n:
                return ([start, len(orig_list) - j - 1],
                        [start, len(new_list) - j - 1])
    else:
        raise RuntimeError(f"editType unknown: {editType}")
    raise RuntimeError(
        f"wrong editing with the specified edit type:\n original: {orig}\n "
        f"new: {new}\n, editType: {editType}")


def get_mask_interval(alignment_rows: List[dict], word_span_ind: Tuple[int, int],
                      editType: str) -> Tuple[float, float]:
    """Alignment rows -> (start_sec, end_sec) of the edit.

    ``word_span_ind`` (s, e) indexes the rows directly (get_span's insertion
    spans are already the neighbouring-word pair [i-1, i]); substitution and
    deletion take [Begin(s), End(e)], insertion the gap [End(s), Begin(e)].
    A row whose Type is not 'words' is skipped at its index."""
    s, e = word_span_ind
    start = None
    end = None
    for j, r in enumerate(alignment_rows):
        is_word = r.get("Type", "words") == "words"
        if j == s and is_word:
            start = float(r["End" if editType == "insertion" else "Begin"])
        if j == e and is_word:
            end = float(r["Begin" if editType == "insertion" else "End"])
            assert start is not None, (s, e, editType)
            break
    assert start is not None and end is not None, (s, e, editType)
    return start, end
