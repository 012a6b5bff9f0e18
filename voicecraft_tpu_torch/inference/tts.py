"""The shared decode entry, zero-shot TTS, best-of-N TTS and speculative TTS
(PyTorch port of voicecraft_tpu/inference/tts.py: ``run_decode``,
``inference_tts``, ``inference_tts_batch``, ``inference_tts_spec`` and
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
from ..models.voicecraft import (SamplingConfig, VoiceCraft, check_mtp_heads,
                                 make_batch_tts_loop, make_decode_loop,
                                 make_spec_decode_loop, make_spec_edit_loop)
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
               stats: Optional[dict] = None, spec: int = 0):
    """Shared decode entry of TTS (one span) and editing (``n_spans`` spans,
    ``queue_mask_ids`` from ``spans.compose_edit_prefix``).  ``spec`` = tau
    >= 2 decodes an edit speculatively (make_spec_edit_loop; the model
    needs tau - 1 MTP head groups); TTS goes through inference_tts_spec.

    Returns a list of the generated spans [K, T_j] (unshifted; a span of at
    most K samples gives [K, 0]), or with ``return_raw`` the recorded
    delayed-space samples and their span indices (gen_buf [n, K], span_buf
    [n]).  ``stats``, when given, receives the prefill length
    (``prefill_len``), the decoder forwards (``steps``; a speculative
    decode's block passes), the feed steps or feed passes among them
    (``feeds``) and the spans started (``spans_done``)."""
    cfg = model.cfg
    x_pad, y_pad, gen_max = decode_geometry(
        cfg, len(x_tokens), prefix.length, is_tts=is_tts, n_spans=n_spans,
        gen_max=gen_max)
    dev = model.device
    xt, yt, mi, qm = pad_inputs(cfg, x_tokens, prefix, x_pad, y_pad, dev,
                                queue_mask_ids)
    if spec > 1:
        if is_tts:
            raise ValueError("speculative TTS goes through inference_tts_spec")
        if fused_ffn:
            raise ValueError("speculative decoding runs the unfused FFN (the "
                             "block forward), as the JAX package does; "
                             "fused_ffn applies to plain decoding")
        check_mtp_heads(model, spec, scfg)
        loop = make_spec_edit_loop(cfg, x_pad=x_pad, y_pad=y_pad,
                                   gen_max=gen_max, scfg=scfg, n_draft=spec)
        res = loop(model, xt, len(x_tokens), yt, prefix.length, mi, qm,
                   n_spans, seed)
        forwards, feeds = res.passes, res.feeds
    else:
        loop = make_decode_loop(cfg, is_tts=is_tts, x_pad=x_pad, y_pad=y_pad,
                                gen_max=gen_max, scfg=scfg,
                                fused_ffn=fused_ffn)
        generator = torch.Generator(device=dev).manual_seed(seed)
        res = loop(model, xt, len(x_tokens), yt, prefix.length, mi, qm,
                   n_spans, generator)
        forwards, feeds = res.forwards, res.forwards - res.gen_cnt
    if stats is not None:
        stats.update(prefill_len=x_pad + y_pad, steps=forwards, feeds=feeds,
                     spans_done=res.spans_done)

    n = res.gen_cnt
    gen_buf = res.gen_buf[:n].cpu().numpy().astype(np.int32)       # [n, K]
    span_buf = res.span_buf[:n].cpu().numpy().astype(np.int32)     # [n]
    if return_raw:
        return gen_buf, span_buf
    return [_unshift(cfg, gen_buf[span_buf == j]) for j in range(n_spans)]


def _unshift(cfg: ModelConfig, rows: np.ndarray) -> np.ndarray:
    """One span's recorded delayed-space rows [n, K] -> codes [K, T]."""
    if rows.shape[0] <= cfg.n_codebooks:
        return np.zeros((cfg.n_codebooks, 0), np.int32)
    return patterns.unshift_span(rows.T).astype(np.int32)


def _tts_prompt(model: VoiceCraft, x_tokens: np.ndarray, y_codes: np.ndarray,
                gen_max: Optional[int]):
    """The padded device inputs of a TTS request and its geometry:
    (y_codes shifted for special_first, prefix length, x_pad, y_pad,
    gen_max, (xt, yt, mi))."""
    cfg = model.cfg
    check_codes(cfg, y_codes)
    if cfg.special_first:
        y_codes = y_codes + cfg.n_special
    prefix = spans.compose_tts_prefix(y_codes, cfg)
    x_pad, y_pad, gen_max = decode_geometry(cfg, len(x_tokens), prefix.length,
                                            gen_max=gen_max)
    xt, yt, mi, _ = pad_inputs(cfg, x_tokens, prefix, x_pad, y_pad,
                               model.device)
    return y_codes, prefix.length, x_pad, y_pad, gen_max, (xt, yt, mi)


def _tts_output(cfg: ModelConfig, y_codes: np.ndarray, gen: np.ndarray):
    full = np.concatenate([y_codes, gen], axis=1)
    if cfg.special_first:
        full = full - cfg.n_special
        gen = gen - cfg.n_special
    return full, gen


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
    return _tts_output(cfg, y_codes, gen)


def inference_tts_batch(model: VoiceCraft, x_tokens: np.ndarray,
                        y_codes: np.ndarray,
                        scfg: SamplingConfig = SamplingConfig(),
                        batch_size: int = 4, seed: int = 1,
                        gen_max: Optional[int] = None,
                        stats: Optional[dict] = None):
    """Best-of-N TTS: ``batch_size`` independent sampling paths over one
    prompt; the path that stops first is returned (make_batch_tts_loop).
    ``stats`` receives the prefill length (``prefill_len``), the decoder
    forwards (``steps``) and the returned path (``keep``).

    Returns (full_codes [K, T+Tg], generated [K, Tg]) as inference_tts."""
    cfg = model.cfg
    y_codes, plen, x_pad, y_pad, gen_max, (xt, yt, mi) = _tts_prompt(
        model, x_tokens, y_codes, gen_max)
    loop = make_batch_tts_loop(cfg, batch_size=batch_size, x_pad=x_pad,
                               y_pad=y_pad, gen_max=gen_max, scfg=scfg)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    res = loop(model, xt, len(x_tokens), yt, plen, mi, generator)
    if stats is not None:
        stats.update(prefill_len=x_pad + y_pad, steps=res.forwards,
                     keep=res.keep)
    rows = res.gen_buf[:res.gen_cnt, res.keep].cpu().numpy()
    return _tts_output(cfg, y_codes, _unshift(cfg, rows))


def inference_tts_spec(model: VoiceCraft, x_tokens: np.ndarray,
                       y_codes: np.ndarray,
                       scfg: SamplingConfig = SamplingConfig(),
                       n_draft: int = 4, seed: int = 1,
                       gen_max: Optional[int] = None,
                       return_stats: bool = False,
                       force_accept: bool = False):
    """Speculative zero-shot TTS through the model's MTP heads
    (make_spec_decode_loop).  Greedy output equals inference_tts's; sampled
    output is an equally valid draw under per-token-index keys.  ``n_draft``
    - 1 must not exceed the model's MTP head groups.  ``force_accept``
    (measurement) accepts every draft: the 100%-acceptance ceiling.

    Returns (full, gen) as inference_tts, plus with ``return_stats`` a dict
    of passes, tokens, tokens_per_pass and prefill_len."""
    cfg = model.cfg
    check_mtp_heads(model, n_draft, scfg)
    y_codes, plen, x_pad, y_pad, gen_max, (xt, yt, mi) = _tts_prompt(
        model, x_tokens, y_codes, gen_max)
    loop = make_spec_decode_loop(cfg, x_pad=x_pad, y_pad=y_pad,
                                 gen_max=gen_max, scfg=scfg, n_draft=n_draft,
                                 force_accept=force_accept)
    res = loop(model, xt, len(x_tokens), yt, plen, mi, seed)
    rows = res.gen_buf[:res.gen_cnt].cpu().numpy()
    full, gen = _tts_output(cfg, y_codes, _unshift(cfg, rows))
    if return_stats:
        return full, gen, {"passes": res.passes, "tokens": res.gen_cnt,
                           "tokens_per_pass": res.gen_cnt / max(res.passes, 1),
                           "prefill_len": x_pad + y_pad}
    return full, gen
