"""Delayed codebook layout, numpy only (port of the numpy side of
voicecraft_tpu/ops/patterns.py and data/spans.py ``_delayed_np``).

For a span of T timesteps and K codebooks the delayed layout has T + K
columns: column 0 is all special, codebook row q holds token t at column
1 + t + q, every other slot holds the special token.
"""

from __future__ import annotations

import numpy as np


def delayed(seg: np.ndarray, empty_token: int) -> np.ndarray:
    """[K, t] -> [K, t + K] delayed interleave (leading empty column, row q
    shifted right by q)."""
    K, t = seg.shape
    out = np.full((K, t + K), empty_token, dtype=np.int32)
    for q in range(K):
        out[q, 1 + q:1 + q + t] = seg[q]
    return out


def slot_timestep(n_q: int, s_max: int) -> np.ndarray:
    """[K, s_max] map column -> original timestep (negative for the leading
    special slots)."""
    q = np.arange(n_q)[:, None]
    col = np.arange(s_max)[None, :]
    return (col - 1 - q).astype(np.int32)


def real_token_mask(t: int, n_q: int, s_max: int) -> np.ndarray:
    """[K, s_max] bool: True where the delayed layout of a span with t
    timesteps holds a real token (column 1+t'+q, 0 <= t' < t)."""
    tt = slot_timestep(n_q, s_max)
    return (tt >= 0) & (tt < t)


def unshift_span(span_kt: np.ndarray) -> np.ndarray:
    """Undo the delay on a generated span [K, S_gen]: row q keeps columns
    [q : S_gen - (K - q)], dropping its leading delay and the trailing eog
    cascade.  Returns [K, S_gen - K]."""
    K, S = span_kt.shape
    return np.stack([span_kt[q, q:S - (K - q)] for q in range(K)], axis=0)
