"""Mask-span sampling and delayed-sequence composition, numpy on the host
(port of voicecraft_tpu/data/spans.py): training's full composition, the TTS
prefix and the multi-span editing prefix.

A training sequence of K codebooks with m masked spans is composed as

    [ D(N_0) M_0 D(N_1) M_1 ... D(N_m) M_m D(G_0) M_{m+1} ... D(G_{m-1}) ]

where N_i are the m + 1 non-masked spans, G_j the m masked spans (moved to
the end), D(.) the delayed interleave of a span with its tail (eog/eos per
the ``eos`` / ``reduced_eog`` rules) and M_j the single mask-placeholder
columns.  Position p's CE target for codebook q is the token at column
p + 1, valid where that slot holds a real token of the same span
(``target_valid_from_real``).

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


def mask_value_ids(n_mask: int, cfg: ModelConfig,
                   rng: Optional[np.random.Generator] = None) -> List[int]:
    """Mask-embedding ids of the 2 * n_mask placeholder columns, shuffled
    by ``rng`` when ``cfg.shuffle_mask_embedding`` (training; inference
    passes no rng and never shuffles)."""
    ids = list(range(cfg.max_n_spans))
    if cfg.shuffle_mask_embedding and rng is not None:
        rng.shuffle(ids)
    use = ids[:n_mask]
    return use + use


# ---- training ------------------------------------------------------------------

def sample_mask_intervals(rng: np.random.Generator, y_len: int,
                          cfg: ModelConfig
                          ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(mask_intervals, non_mask_intervals) of one utterance of y_len frames.

    The reference's distribution: n_spans ~ clamp(Poisson(lam), 1, max) or
    uniform; starts drawn without replacement from [1, y_len - 1 - min_len);
    a start closer than min_gap to the previous one is dropped, and so is a
    start with no room for a span; span lengths uniform in [min, max],
    redrawn from [1, gap - 1] where they would overlap the next start."""
    if cfg.mask_sample_dist == "uniform":
        n_spans = int(rng.integers(1, cfg.max_n_spans + 1))
    elif cfg.mask_sample_dist.lower().startswith("poisson"):
        lam = float(cfg.mask_sample_dist[len("poisson"):])
        n_spans = int(np.clip(rng.poisson(lam), 1, cfg.max_n_spans))
    else:
        raise ValueError(cfg.mask_sample_dist)

    hi = y_len - 1 - cfg.mask_len_min
    assert hi > 1, f"utterance too short to mask: y_len={y_len}"
    n_spans = min(n_spans, hi - 1)
    starts = sorted(rng.choice(np.arange(1, hi), size=n_spans,
                               replace=False).tolist())
    for j in range(len(starts) - 1, 0, -1):
        if starts[j] - starts[j - 1] < cfg.min_gap:
            del starts[j]
    assert len(starts) > 0
    # a start less than 2 before the next (or y_len) cannot host a span of
    # length 1
    for j in range(len(starts) - 1, -1, -1):
        nxt = starts[j + 1] if j + 1 < len(starts) else y_len
        if nxt - starts[j] < 2 and len(starts) > 1:
            del starts[j]

    temp_starts = starts + [y_len]
    gaps = [temp_starts[j + 1] - temp_starts[j] for j in range(len(starts))]
    ends = []
    for start, gap in zip(starts, gaps):
        assert gap >= 2, (start, gap, y_len)
        mask_len = int(rng.integers(cfg.mask_len_min, cfg.mask_len_max + 1))
        if mask_len > gap - 1:
            mask_len = int(rng.integers(1, gap))  # uniform on [1, gap - 1]
        ends.append(start + mask_len)

    mask_intervals = list(zip(starts, ends))
    non_mask_intervals = list(zip([0] + ends, starts + [y_len]))
    return mask_intervals, non_mask_intervals


def compose_sequence(y: np.ndarray,
                     mask_intervals: Sequence[Tuple[int, int]],
                     non_mask_intervals: Sequence[Tuple[int, int]],
                     cfg: ModelConfig,
                     rng: Optional[np.random.Generator] = None
                     ) -> ComposedSequence:
    """The training composition of codes ``y`` [K, T] (layout in the module
    docstring): every span, every mask placeholder."""
    K = y.shape[0]
    m = len(mask_intervals)
    tails = segment_tails(len(non_mask_intervals), m, cfg)
    segs = ([_span_tokens(y, lo, hi, t)
             for (lo, hi), t in zip(non_mask_intervals, tails[:m + 1])]
            + [_span_tokens(y, lo, hi, t)
               for (lo, hi), t in zip(mask_intervals, tails[m + 1:])])

    mv = mask_value_ids(m, cfg, rng)
    cols_tokens, cols_mask, cols_real = [], [], []
    for i, seg in enumerate(segs):
        d = patterns.delayed(seg, cfg.empty_token)
        cols_tokens.append(d)
        cols_mask.append(np.full(d.shape[1], -1, np.int32))
        cols_real.append(patterns.real_token_mask(seg.shape[1], K, d.shape[1]))
        if i < len(segs) - 1:  # 2m placeholders between 2m + 1 segments
            cols_tokens.append(np.full((K, 1), cfg.eog, np.int32))
            cols_mask.append(np.asarray([mv[i]], np.int32))
            cols_real.append(np.zeros((K, 1), bool))

    tokens = np.concatenate(cols_tokens, axis=1).astype(np.int32)
    S = tokens.shape[1]
    y_len = int(sum(hi - lo for lo, hi in mask_intervals)
                + sum(hi - lo for lo, hi in non_mask_intervals))
    n_tails = sum(1 for t in tails if t is not None)
    assert S == y_len + n_tails + (2 * m + 1) * K + 2 * m, (S, y_len, m)
    return ComposedSequence(tokens, np.concatenate(cols_mask),
                            np.concatenate(cols_real, axis=1), S)


def target_valid_from_real(real: np.ndarray) -> np.ndarray:
    """valid[q, p] = real[q, p + 1]: the next slot holds a real token."""
    v = np.zeros_like(real)
    v[:, :-1] = real[:, 1:]
    return v


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
