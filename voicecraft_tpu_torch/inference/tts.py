"""The shared decode entry and zero-shot TTS (PyTorch port of
voicecraft_tpu/inference/tts.py: ``run_decode``, ``inference_tts`` and
``find_closest_word_boundary``).

Geometries are rounded up as in the JAX package (x to 32, the y prefix to
64, the generation cap to 128), so both packages decode with the same slab.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig

from ..data import spans
from ..models.voicecraft import SamplingConfig, VoiceCraft, make_decode_loop
from ..ops import patterns


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def find_closest_word_boundary(rows, cut_off_sec: float, margin: float = 0.04,
                               cutoff_tolerance: float = 1.0):
    """Snap a prompt cutoff time to an alignment boundary.

    ``rows`` are (Begin, End) pairs of an alignment in file order (every
    row, words and phones alike, as the reference scans them).  Takes the
    first boundary within ``cutoff_tolerance`` after the requested time
    with at least ``margin`` of silence before the next row, placing the
    cut 2/3 of the margin into the gap; otherwise the first boundary at or
    after the requested time.

    Returns (cutoff_sec, row_index); both None when no boundary is found.
    """
    cutoff_time = None
    cutoff_index = None
    for i, (_, end) in enumerate(rows):
        end = float(end)
        if end >= cut_off_sec and cutoff_time is None:
            cutoff_time = end
            cutoff_index = i
        if (end >= cut_off_sec and end < cut_off_sec + cutoff_tolerance
                and i + 1 < len(rows)
                and float(rows[i + 1][0]) - end >= margin):
            return end + margin * 2 / 3, i
    return cutoff_time, cutoff_index


def decode_geometry(cfg: ModelConfig, x_len: int, prefix_len: int, *,
                    is_tts: bool = True, n_spans: int = 1,
                    gen_max: Optional[int] = None) -> Tuple[int, int, int]:
    """(x_pad, y_pad, gen_max) of a decode: without ``gen_max``, enough
    samples to reach the forced-eog length cap plus the cascade, and 3 more
    per span transition."""
    K = cfg.n_codebooks
    cap_mult = (cfg.encodec_sr // 5) if is_tts else 10
    if gen_max is None:
        gen_max = max(x_len * cap_mult - prefix_len + K + 8, 2 * K + 8)
        gen_max += 3 * max(n_spans - 1, 0)
    return (_round_up(x_len, 32), _round_up(prefix_len, 64),
            _round_up(gen_max, 128))


def pad_inputs(cfg: ModelConfig, x_tokens: np.ndarray,
               prefix: spans.ComposedSequence, x_pad: int, y_pad: int,
               device, queue_mask_ids: Sequence[int] = ()
               ) -> Tuple[torch.Tensor, ...]:
    """Text tokens [1, x_pad], the composed prefix [1, K, y_pad], its
    mask-embedding ids [1, y_pad] and the queued mask ids [max_n_spans],
    padded and on ``device``."""
    K = cfg.n_codebooks
    xt = np.full((1, x_pad), cfg.text_pad_token, np.int64)
    xt[0, :len(x_tokens)] = x_tokens
    yt = np.full((1, K, y_pad), cfg.empty_token, np.int64)
    yt[0, :, :prefix.length] = prefix.tokens
    mi = np.full((1, y_pad), -1, np.int64)
    mi[0, :prefix.length] = prefix.mask_emb_idx
    qm = np.zeros((cfg.max_n_spans,), np.int64)
    ids = list(queue_mask_ids)[:cfg.max_n_spans]
    qm[:len(ids)] = ids
    return tuple(torch.from_numpy(a).to(device) for a in (xt, yt, mi, qm))


def run_decode(model: VoiceCraft, *, is_tts: bool, x_tokens: np.ndarray,
               prefix: spans.ComposedSequence, n_spans: int,
               scfg: SamplingConfig, queue_mask_ids: Sequence[int] = (),
               seed: int = 1, gen_max: Optional[int] = None,
               return_raw: bool = False, fused_ffn: bool = False,
               stats: Optional[dict] = None):
    """Shared decode entry of TTS (one span) and editing (``n_spans`` spans,
    ``queue_mask_ids`` from ``spans.compose_edit_prefix``).

    Returns a list of the generated spans [K, T_j] (unshifted; a span of at
    most K samples gives [K, 0]), or with ``return_raw`` the recorded
    delayed-space samples and their span indices (gen_buf [n, K], span_buf
    [n]).  ``stats``, when given, receives the prefill length
    (``prefill_len``), the decoder forwards (``steps``), the feed steps
    among them (``feeds``) and the spans started (``spans_done``)."""
    cfg = model.cfg
    K = cfg.n_codebooks
    x_pad, y_pad, gen_max = decode_geometry(
        cfg, len(x_tokens), prefix.length, is_tts=is_tts, n_spans=n_spans,
        gen_max=gen_max)
    dev = model.device
    xt, yt, mi, qm = pad_inputs(cfg, x_tokens, prefix, x_pad, y_pad, dev,
                                queue_mask_ids)
    loop = make_decode_loop(cfg, is_tts=is_tts, x_pad=x_pad, y_pad=y_pad,
                            gen_max=gen_max, scfg=scfg, fused_ffn=fused_ffn)
    generator = torch.Generator(device=dev).manual_seed(seed)
    res = loop(model, xt, len(x_tokens), yt, prefix.length, mi, qm, n_spans,
               generator)
    if stats is not None:
        stats.update(prefill_len=x_pad + y_pad, steps=res.forwards,
                     feeds=res.forwards - res.gen_cnt,
                     spans_done=res.spans_done)

    n = res.gen_cnt
    gen_buf = res.gen_buf[:n].cpu().numpy().astype(np.int32)       # [n, K]
    span_buf = res.span_buf[:n].cpu().numpy().astype(np.int32)     # [n]
    if return_raw:
        return gen_buf, span_buf
    out_spans = []
    for j in range(n_spans):
        rows = gen_buf[span_buf == j]                              # [n_j, K]
        if rows.shape[0] <= K:
            out_spans.append(np.zeros((K, 0), np.int32))
            continue
        out_spans.append(patterns.unshift_span(rows.T).astype(np.int32))
    return out_spans


def check_codes(cfg: ModelConfig, y_codes: np.ndarray) -> None:
    """Codes of a prompt or of an edited recording must embed."""
    if y_codes.size and (y_codes.min() < 0
                         or y_codes.max() >= cfg.audio_vocab_size):
        raise ValueError(f"codes must lie in [0, {cfg.audio_vocab_size}) "
                         "(the model's audio vocabulary)")


def inference_tts(model: VoiceCraft, x_tokens: np.ndarray, y_codes: np.ndarray,
                  scfg: SamplingConfig = SamplingConfig(), seed: int = 1,
                  gen_max: Optional[int] = None, fused_ffn: bool = False,
                  stats: Optional[dict] = None):
    """Zero-shot TTS: continue the voice prompt ``y_codes`` [K, T] for the
    phoneme sequence ``x_tokens`` [Lx].  ``fused_ffn`` runs the decode-step
    FFN through the fused kernel.

    Returns (full_codes [K, T+Tg], generated [K, Tg])."""
    cfg = model.cfg
    check_codes(cfg, y_codes)
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
