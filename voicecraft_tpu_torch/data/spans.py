"""Delayed-sequence composition for inference prefixes (port of
voicecraft_tpu/data/spans.py: the TTS prefix and the multi-span editing
prefix; training's composition comes with the trainer).

An editing prefix for m masked spans keeps the m + 1 non-masked spans N_i,
each delayed with its tail (eog/eos per the ``eos`` / ``reduced_eog``
rules), each followed by one mask-placeholder column M_i, and ends with the
first (all-empty) column of generated span 0:

    [ D(N_0) M_0 D(N_1) M_1 ... D(N_m) M_m empty ]

The masked spans themselves are generated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import ModelConfig

from ..ops import patterns


@dataclass
class ComposedSequence:
    tokens: np.ndarray        # [K, S] int32 (delayed space, incl. placeholders)
    mask_emb_idx: np.ndarray  # [S] int32, -1 where not a mask column
    real: np.ndarray          # [K, S] bool — slot holds a real span token
    length: int


def _span_tokens(y: np.ndarray, lo: int, hi: int,
                 tail: Optional[int]) -> np.ndarray:
    """y[:, lo:hi], with a tail token column (eog/eos) appended if given."""
    seg = y[:, lo:hi]
    if tail is not None:
        seg = np.concatenate(
            [seg, np.full((y.shape[0], 1), tail, dtype=y.dtype)], axis=1)
    return seg


def segment_tails(n_non_mask: int, n_mask: int,
                  cfg: ModelConfig) -> List[Optional[int]]:
    """The eog/eos appended to each span, in composition order: the
    non-masked spans, then the masked ones."""
    tails: List[Optional[int]] = []
    for i in range(n_non_mask):
        last = i == n_non_mask - 1
        if cfg.eos > 0:
            assert cfg.reduced_eog
            tails.append(cfg.eos if last else None)
        elif cfg.reduced_eog:
            tails.append(cfg.eog if last else None)
        else:
            tails.append(cfg.eog)
    tails.extend([cfg.eog] * n_mask)
    return tails


def mask_value_ids(n_mask: int, cfg: ModelConfig) -> List[int]:
    """Mask-embedding ids of the 2 * n_mask placeholder columns (inference
    never shuffles them)."""
    use = list(range(cfg.max_n_spans))[:n_mask]
    return use + use


def compose_edit_prefix(y: np.ndarray,
                        mask_intervals: Sequence[Tuple[int, int]],
                        cfg: ModelConfig) -> Tuple[ComposedSequence, List[int]]:
    """The editing prefix of codes ``y`` [K, T] whose sorted
    ``mask_intervals`` get regenerated (layout in the module docstring).

    Returns (prefix, queue_mask_ids): queue_mask_ids[j] is the
    mask-embedding id fed before generated span j (j >= 1)."""
    K, y_len = y.shape
    m = len(mask_intervals)
    starts = [s for s, _ in mask_intervals]
    ends = [e for _, e in mask_intervals]
    non_mask_intervals = list(zip([0] + ends, starts + [y_len]))

    tails = segment_tails(len(non_mask_intervals), m, cfg)
    mv = mask_value_ids(m, cfg)

    cols_tokens, cols_mask, cols_real = [], [], []
    for i, (lo, hi) in enumerate(non_mask_intervals):
        seg = _span_tokens(y, lo, hi, tails[i])
        d = patterns.delayed(seg, cfg.empty_token)
        cols_tokens.append(d)
        cols_mask.append(np.full(d.shape[1], -1, np.int32))
        cols_real.append(patterns.real_token_mask(seg.shape[1], K, d.shape[1]))
        # the placeholder after every non-masked span
        cols_tokens.append(np.full((K, 1), cfg.eog, np.int32))
        cols_mask.append(np.asarray([mv[i] if i < len(mv) else 0], np.int32))
        cols_real.append(np.zeros((K, 1), bool))
    # the first (all-empty) column of generated span 0
    cols_tokens.append(np.full((K, 1), cfg.empty_token, np.int32))
    cols_mask.append(np.asarray([-1], np.int32))
    cols_real.append(np.zeros((K, 1), bool))

    prefix = ComposedSequence(
        np.concatenate(cols_tokens, axis=1).astype(np.int32),
        np.concatenate(cols_mask),
        np.concatenate(cols_real, axis=1),
        sum(c.shape[1] for c in cols_tokens),
    )
    queue_mask_ids = [mv[m + j] if m + j < len(mv) else 0 for j in range(m)]
    return prefix, queue_mask_ids


def compose_tts_prefix(y: np.ndarray, cfg: ModelConfig) -> ComposedSequence:
    """TTS prefix: the delayed prompt with its trailing K-1 columns cut, so
    T + 1 columns for a [K, T] prompt."""
    K, T = y.shape
    d = patterns.delayed(y, cfg.empty_token)[:, :T + 1]
    real = patterns.real_token_mask(T, K, T + K)[:, :T + 1]
    return ComposedSequence(d.astype(np.int32),
                            np.full(T + 1, -1, np.int32), real, T + 1)
