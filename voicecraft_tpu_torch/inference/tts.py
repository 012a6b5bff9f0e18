"""Zero-shot TTS inference entry points (PyTorch port of
voicecraft_tpu/inference/tts.py: ``run_decode`` and ``inference_tts``).

Geometries are rounded up as in the JAX package (x to 32, the y prefix to
64, the generation cap to 128), so both packages decode with the same slab.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig

from ..data import spans
from ..models.voicecraft import SamplingConfig, VoiceCraft, make_decode_loop
from ..ops import patterns


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def decode_geometry(cfg: ModelConfig, x_len: int, prefix_len: int, *,
                    is_tts: bool = True, n_spans: int = 1,
                    gen_max: Optional[int] = None) -> Tuple[int, int, int]:
    """(x_pad, y_pad, gen_max) of a decode: without ``gen_max``, enough steps
    to reach the forced-eog length cap plus the cascade."""
    K = cfg.n_codebooks
    cap_mult = (cfg.encodec_sr // 5) if is_tts else 10
    if gen_max is None:
        gen_max = max(x_len * cap_mult - prefix_len + K + 8, 2 * K + 8)
        gen_max += 3 * max(n_spans - 1, 0)
    return (_round_up(x_len, 32), _round_up(prefix_len, 64),
            _round_up(gen_max, 128))


def pad_inputs(cfg: ModelConfig, x_tokens: np.ndarray,
               prefix: spans.ComposedSequence, x_pad: int, y_pad: int,
               device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Text tokens [1, x_pad], the composed prefix [1, K, y_pad] and its
    mask-embedding ids [1, y_pad], padded and on ``device``."""
    K = cfg.n_codebooks
    xt = np.full((1, x_pad), cfg.text_pad_token, np.int64)
    xt[0, :len(x_tokens)] = x_tokens
    yt = np.full((1, K, y_pad), cfg.empty_token, np.int64)
    yt[0, :, :prefix.length] = prefix.tokens
    mi = np.full((1, y_pad), -1, np.int64)
    mi[0, :prefix.length] = prefix.mask_emb_idx
    return tuple(torch.from_numpy(a).to(device) for a in (xt, yt, mi))


def run_decode(model: VoiceCraft, *, is_tts: bool, x_tokens: np.ndarray,
               prefix: spans.ComposedSequence, n_spans: int,
               scfg: SamplingConfig, seed: int = 1,
               gen_max: Optional[int] = None, return_raw: bool = False,
               fused_ffn: bool = False, stats: Optional[dict] = None):
    """Shared decode entry (one span: multi-span editing is not yet
    ported).  Returns a list of generated spans [K, T_j] (unshifted), or
    with ``return_raw`` the per-step delayed-space samples [n, K].
    ``stats``, when given, receives the prefill length (``prefill_len``)
    and the number of decode steps (``steps``)."""
    cfg = model.cfg
    K = cfg.n_codebooks
    x_pad, y_pad, gen_max = decode_geometry(
        cfg, len(x_tokens), prefix.length, is_tts=is_tts, n_spans=n_spans,
        gen_max=gen_max)
    dev = model.device
    xt, yt, mi = pad_inputs(cfg, x_tokens, prefix, x_pad, y_pad, dev)
    loop = make_decode_loop(cfg, is_tts=is_tts, x_pad=x_pad, y_pad=y_pad,
                            gen_max=gen_max, scfg=scfg, fused_ffn=fused_ffn)
    generator = torch.Generator(device=dev).manual_seed(seed)
    gen_buf, steps = loop(model, xt, len(x_tokens), yt, prefix.length, mi,
                          n_spans, generator)
    if stats is not None:
        stats["prefill_len"] = x_pad + y_pad
        stats["steps"] = steps

    rows = gen_buf[:steps].cpu().numpy().astype(np.int32)           # [n, K]
    if return_raw:
        return rows
    if rows.shape[0] <= K:
        return [np.zeros((K, 0), np.int32)]
    return [patterns.unshift_span(rows.T).astype(np.int32)]


def inference_tts(model: VoiceCraft, x_tokens: np.ndarray, y_codes: np.ndarray,
                  scfg: SamplingConfig = SamplingConfig(), seed: int = 1,
                  gen_max: Optional[int] = None, fused_ffn: bool = False,
                  stats: Optional[dict] = None):
    """Zero-shot TTS: continue the voice prompt ``y_codes`` [K, T] for the
    phoneme sequence ``x_tokens`` [Lx].  ``fused_ffn`` runs the decode-step
    FFN through the fused kernel.

    Returns (full_codes [K, T+Tg], generated [K, Tg])."""
    cfg = model.cfg
    if y_codes.size and (y_codes.min() < 0
                         or y_codes.max() >= cfg.audio_vocab_size):
        raise ValueError(f"prompt codes must lie in [0, {cfg.audio_vocab_size}) "
                         "(the model's audio vocabulary)")
    if cfg.special_first:
        y_codes = y_codes + cfg.n_special
    prefix = spans.compose_tts_prefix(y_codes, cfg)
    gen = run_decode(model, is_tts=True, x_tokens=x_tokens, prefix=prefix,
                     n_spans=1, scfg=scfg, seed=seed, gen_max=gen_max,
                     fused_ffn=fused_ffn, stats=stats)[0]
    full = np.concatenate([y_codes, gen], axis=1)
    if cfg.special_first:
        full = full - cfg.n_special
        gen = gen - cfg.n_special
    return full, gen
