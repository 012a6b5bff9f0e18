"""Delayed-sequence composition for inference prefixes (port of
voicecraft_tpu/data/spans.py, the TTS part)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import ModelConfig

from ..ops import patterns


@dataclass
class ComposedSequence:
    tokens: np.ndarray        # [K, S] int32 (delayed space, incl. placeholders)
    mask_emb_idx: np.ndarray  # [S] int32, -1 where not a mask column
    real: np.ndarray          # [K, S] bool — slot holds a real span token
    length: int


def compose_tts_prefix(y: np.ndarray, cfg: ModelConfig) -> ComposedSequence:
    """TTS prefix: the delayed prompt with its trailing K-1 columns cut, so
    T + 1 columns for a [K, T] prompt."""
    K, T = y.shape
    d = patterns.delayed(y, cfg.empty_token)[:, :T + 1]
    real = patterns.real_token_mask(T, K, T + K)[:, :T + 1]
    return ComposedSequence(d.astype(np.int32),
                            np.full(T + 1, -1, np.int32), real, T + 1)
