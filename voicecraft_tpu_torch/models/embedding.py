"""Sinusoidal positional table (port of voicecraft_tpu/models/embedding.py).
The learnable alphas that scale it live on models.voicecraft.VoiceCraft."""

from __future__ import annotations

import numpy as np


def sine_table(max_len: int, dim: int) -> np.ndarray:
    """[max_len, dim] float32 sine/cosine table."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, dim, 2, dtype=np.float64) * -(np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)
