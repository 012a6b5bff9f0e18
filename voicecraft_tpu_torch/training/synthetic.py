"""A synthetic training batch: random codes and text composed as the
trainer composes real ones (the port's copy of the JAX package's
benchmark batch, ``__graft_entry__._synthetic_batch``).

The same numpy draws in the same order (``spans.sample_mask_intervals``,
``spans.compose_sequence``, ``spans.target_valid_from_real``), so a seed
gives the same arrays in both packages; the composed length is padded to
a multiple of 64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..data import spans
from ..models.voicecraft import TrainBatch


def synthetic_batch(cfg: ModelConfig, B: int, Sx: int, y_len: int,
                    seed: int = 0, device="cuda") -> TrainBatch:
    """B rows of ``Sx`` random text tokens and ``y_len`` frames of random
    codes, each with mask intervals sampled as in training; a TrainBatch
    on ``device``."""
    rng = np.random.default_rng(seed)
    K = cfg.n_codebooks
    comps = []
    for _ in range(B):
        y = rng.integers(0, cfg.audio_vocab_size, (K, y_len)).astype(np.int32)
        mi, nmi = spans.sample_mask_intervals(rng, y_len, cfg)
        comps.append(spans.compose_sequence(y, mi, nmi, cfg))
    Sy = max(c.length for c in comps)
    Sy = ((Sy + 63) // 64) * 64
    x = rng.integers(0, cfg.text_vocab_size, (B, Sx)).astype(np.int32)
    x_lens = np.full((B,), Sx, np.int32)
    y_tok = np.full((B, K, Sy), cfg.audio_pad_token, np.int32)
    midx = np.full((B, Sy), -1, np.int32)
    tval = np.zeros((B, K, Sy), bool)
    for b, c in enumerate(comps):
        y_tok[b, :, :c.length] = c.tokens
        midx[b, :c.length] = c.mask_emb_idx
        tval[b, :, :c.length] = spans.target_valid_from_real(c.real)
    y_lens = np.asarray([c.length for c in comps], np.int32)
    return TrainBatch(*(torch.from_numpy(a).to(device)
                        for a in (x, x_lens, y_tok, y_lens, midx, tval)))
