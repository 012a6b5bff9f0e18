"""VoiceCraft model and its zero-shot TTS decode loop (PyTorch port of
voicecraft_tpu/models/voicecraft.py).

``VoiceCraft`` holds the parameters: per-codebook audio embeddings (summed),
text and mask embeddings, sine positional embeddings scaled by learnable
alphas, the pre-norm decoder, and per-codebook 2-layer GELU heads.
Embedding tables, alphas, LayerNorm parameters and head biases are f32, as
the JAX code reads them; every weight matrix is stored once in the compute
dtype.

The decode loop keeps its state in device tensors of static shape (the
write pointer, the sampling state, the token buffer) and syncs with the host
once per step, for ``done``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from voicecraft_tpu.config import ModelConfig

from ..ops.flash_attention import prefill_attention
from ..ops.sampling import sample
from . import transformer as trm
from .embedding import sine_table

BAN = -10000.0  # the reference's in-place logit ban value

MAX_POS = 4096  # positional table size


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.compute_dtype]


class Heads(nn.Module):
    """K prediction heads Linear(D, half) -> GELU -> Linear(half, card),
    stacked along a leading K axis."""

    def __init__(self, K: int, d_model: int, half: int, card: int,
                 dtype: torch.dtype, device):
        super().__init__()
        f32 = torch.float32
        self.w1 = trm._param(K, d_model, half, dtype=dtype, device=device)
        self.b1 = trm._param(K, half, dtype=f32, device=device)
        self.w2 = trm._param(K, half, card, dtype=dtype, device=device)
        self.b2 = trm._param(K, card, dtype=f32, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        D, half = self.w1.shape[1:]
        for t, bound in ((self.w1, D ** -0.5), (self.b1, D ** -0.5),
                         (self.w2, half ** -0.5), (self.b2, half ** -0.5)):
            t.uniform_(-bound, bound, generator=generator)


class VoiceCraft(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        K, D, f32 = cfg.n_codebooks, cfg.d_model, torch.float32
        self.text_emb = trm._param(cfg.n_text_tokens, D, dtype=f32, device=device)
        self.audio_emb = trm._param(K, cfg.card, D, dtype=f32, device=device)
        self.mask_emb = trm._param(cfg.max_n_spans, D, dtype=f32, device=device)
        self.alpha_text = trm._param(dtype=f32, device=device)
        self.alpha_audio = trm._param(dtype=f32, device=device)
        self.decoder = trm.Decoder(cfg.num_decoder_layers, D, cfg.nhead,
                                   cfg.ffn_dim, self.dtype, device,
                                   norm=cfg.norm, activation=cfg.ffn_activation)
        self.heads = Heads(K, D, cfg.audio_vocab_size // 2, cfg.card,
                           self.dtype, device)
        self.register_buffer("pe", torch.from_numpy(sine_table(MAX_POS, D)).to(device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.text_emb.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VoiceCraft":
        """Random weights with the distributions of the JAX package's
        ``init_params``."""
        for t in (self.text_emb, self.audio_emb, self.mask_emb):
            t.normal_(generator=generator)
        self.alpha_text.fill_(1.0)
        self.alpha_audio.fill_(1.0)
        self.decoder.init_weights(generator)
        self.heads.init_weights(generator)
        return self


def embed_audio_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Sum of per-codebook embeddings: table [K, card, D], tokens [B, K, T]
    -> [B, T, D] in the table's dtype."""
    out = table[0][tokens[:, 0]]
    for k in range(1, table.shape[0]):
        out = out + table[k][tokens[:, k]]
    return out


def apply_heads(heads: Heads, h: torch.Tensor) -> torch.Tensor:
    """h [N, D] -> logits [N, K, card] in f32 (exact-erf GELU)."""
    h1 = torch.matmul(h.unsqueeze(0), heads.w1.to(h.dtype)).float()  # [K,N,half]
    h1 = F.gelu(h1 + heads.b1[:, None].float(), approximate="none")
    logits = torch.matmul(h1.to(h.dtype), heads.w2.to(h.dtype)).float()  # [K,N,card]
    return (logits + heads.b2[:, None].float()).transpose(0, 1)


def embed_prefix(model: VoiceCraft, x_tokens: torch.Tensor,
                 y_prefix: torch.Tensor, mask_emb_idx: torch.Tensor
                 ) -> torch.Tensor:
    """The prefill input [1, x_pad + y_pad, D] in the compute dtype: text
    and audio embeddings (mask embeddings at mask columns), each plus its
    alpha-scaled positional term.  x_tokens [1, x_pad], y_prefix
    [1, K, y_pad], mask_emb_idx [1, y_pad] (-1 where not a mask column)."""
    dtype = model.dtype
    pe = model.pe.to(dtype)
    x_pad, y_pad = x_tokens.shape[1], y_prefix.shape[2]
    x_in = (model.text_emb[x_tokens].to(dtype)
            + model.alpha_text.to(dtype) * pe[:x_pad])
    y_emb = embed_audio_tokens(model.audio_emb, y_prefix).to(dtype)
    mask_vecs = model.mask_emb[mask_emb_idx.clamp(min=0)].to(dtype)
    y_emb = torch.where((mask_emb_idx >= 0)[..., None], mask_vecs, y_emb)
    y_in = y_emb + model.alpha_audio.to(dtype) * pe[:y_pad]
    return torch.cat([x_in, y_in], dim=1)


def embed_step(model: VoiceCraft, samples: torch.Tensor,
               y_pos: torch.Tensor) -> torch.Tensor:
    """The decode-step input [1, 1, D]: the summed embedding of one
    delayed-space column ``samples`` [K] at audio position ``y_pos`` (a 0-d
    tensor, read on the device)."""
    dtype = model.dtype
    emb = embed_audio_tokens(model.audio_emb, samples[None, :, None])[0, 0].to(dtype)
    pe = model.pe.index_select(0, y_pos.view(1)).to(dtype)
    return (emb + model.alpha_audio.to(dtype) * pe)[None]


# ==============================================================================
# sampling machinery
# ==============================================================================

@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling knobs of one decode run."""
    top_k: int = 0                  # <=0 disables (reference default -100)
    top_p: float = 1.0
    temperature: float = 1.0        # <=0 -> greedy
    stop_repetition: int = 3
    silence_tokens: Tuple[int, ...] = (1388, 1898, 131)


@functools.lru_cache(maxsize=16)
def _silence_tokens(tokens: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The silence tokens as a device tensor, made once (a host-to-device
    copy per decode step would stall the loop)."""
    return torch.tensor(tokens, device=device)


def _adjust_logits(cfg: ModelConfig, scfg: SamplingConfig, is_tts: bool,
                   logits_k, codebook_eog, cur_num_gen, consec_silence,
                   prev_token):
    """Pre-sampling logit adjustments of the reference sample_helper twins:
    the eog/eos bans, the min-length guard and the silence-repetition
    penalty.  logits_k: [K, card] f32; the state arguments are 0-d tensors
    (codebook_eog: [K] bool)."""
    K, card = logits_k.shape
    dev = logits_k.device
    eog_stop = cfg.eog_inference if is_tts else cfg.eog
    rows = torch.arange(K, device=dev)[:, None]
    cols = torch.arange(card, device=dev)[None, :]
    n_eog = codebook_eog.sum()

    la = logits_k
    if cfg.eos > 0:
        # TTS bans eog everywhere, editing bans eos everywhere
        la = la.masked_fill(cols == (cfg.eog if is_tts else cfg.eos), BAN)
    # rows beyond the next-to-finish codebook may not emit eog/empty
    ban = (rows > n_eog) & ((cols == eog_stop) | (cols == cfg.empty_token))
    la = la.masked_fill(ban, BAN)
    if is_tts:
        min_guard = cur_num_gen <= cfg.encodec_sr // 5
        la = la.masked_fill(min_guard & (rows == 0) & (cols == eog_stop), BAN)
    if scfg.stop_repetition > 0 and len(scfg.silence_tokens) > 0:
        sil = _silence_tokens(scfg.silence_tokens, dev)
        hit = ((sil == prev_token).any()
               & (consec_silence > scfg.stop_repetition) & (n_eog == 0))
        denom = (consec_silence - (scfg.stop_repetition - 1)).float()
        cell = (rows == 0) & (cols == prev_token)
        penalised = torch.where(la < 0, la * denom, la / denom.clamp(min=1.0))
        la = torch.where(hit & cell, penalised, la)
    return la


def _finalize_sample(cfg: ModelConfig, scfg: SamplingConfig, is_tts: bool,
                     cap_mult: int, la, samples, codebook_eog, cur_num_gen,
                     consec_silence, prev_token, y_pos, x_len):
    """Post-sampling machinery of the reference sample_helper twins: forced
    empties for a span's first K-1 steps, the eog stop check (which sees the
    ADJUSTED row 0), silence counters, and the eog cascade.  Returns
    (samples [K], codebook_eog [K], consec_silence, prev_token)."""
    K = la.shape[0]
    dev = la.device
    eog_stop = cfg.eog_inference if is_tts else cfg.eog
    n_eog = codebook_eog.sum()
    r = torch.arange(K, device=dev)

    # ---- n_eog == 0: forced empties, stop check, silence counters ----
    s0 = torch.where(r > cur_num_gen, cfg.empty_token, samples)
    stop_hit = ((s0[0] == eog_stop) | (la[0].argmax() == eog_stop)
                | (y_pos > x_len * cap_mult))
    s0 = torch.where(r == 0, torch.where(stop_hit, eog_stop, s0[0]), s0)
    eog0 = torch.where(r == 0, stop_hit, codebook_eog)
    if len(scfg.silence_tokens) > 0:
        sil = _silence_tokens(scfg.silence_tokens, dev)
        is_sil = (sil == s0[0]).any() & (s0[0] == prev_token)
    else:
        is_sil = torch.zeros((), dtype=torch.bool, device=dev)
    consec0 = torch.where(is_sil, consec_silence + 1, 0)
    prev0 = s0[0]

    # ---- n_eog > 0: continue the eog cascade ----
    s1 = torch.where(r < n_eog, cfg.empty_token, samples)
    s1 = torch.where(r == n_eog, eog_stop, s1)
    eog1 = codebook_eog | (r == n_eog)

    first = n_eog == 0
    return (torch.where(first, s0, s1), torch.where(first, eog0, eog1),
            torch.where(first, consec0, consec_silence),
            torch.where(first, prev0, prev_token))


def _adjust_and_sample(cfg: ModelConfig, scfg: SamplingConfig, is_tts: bool,
                       cap_mult: int, generator, logits_k, codebook_eog,
                       cur_num_gen, consec_silence, prev_token, y_pos, x_len):
    """One sampling decision for a single sample (logits_k [K, card] f32):
    logit adjustments, a draw, then the deterministic finalisation."""
    la = _adjust_logits(cfg, scfg, is_tts, logits_k, codebook_eog,
                        cur_num_gen, consec_silence, prev_token)
    samples = sample(generator, la, scfg.top_k, scfg.top_p, scfg.temperature)
    return _finalize_sample(cfg, scfg, is_tts, cap_mult, la, samples,
                            codebook_eog, cur_num_gen, consec_silence,
                            prev_token, y_pos, x_len)


# ==============================================================================
# decode loop
# ==============================================================================

def make_decode_loop(cfg: ModelConfig, *, is_tts: bool, x_pad: int,
                     y_pad: int, gen_max: int, scfg: SamplingConfig,
                     fused_ffn: bool = False):
    """The single-sample, single-span decode function for one geometry.

    Static geometry: x padded to ``x_pad``, the composed y prefix padded to
    ``y_pad``, at most ``gen_max`` decode steps.  The slab keeps the JAX
    package's size, with room for the span-transition feeds of editing
    (not yet ported: n_spans must be 1).

    Returns decode(model, x_tokens [1, x_pad], x_len, y_prefix [1, K, y_pad],
    prefix_len, mask_emb_idx [1, y_pad], n_spans, generator)
      -> (gen_buf [gen_max, K] on the device, number of decode steps).
    """
    K = cfg.n_codebooks
    H, Dh, L = cfg.nhead, cfg.head_dim, cfg.num_decoder_layers
    cap_mult = (cfg.encodec_sr // 5) if is_tts else 10
    s_max = x_pad + y_pad + gen_max + 2 * (cfg.max_n_spans - 1)

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_len: int, y_prefix,
               prefix_len: int, mask_emb_idx, n_spans: int,
               generator: Optional[torch.Generator]):
        if n_spans != 1:
            raise NotImplementedError("multi-span editing decode is not yet "
                                      "ported (n_spans must be 1)")
        dev, dtype = model.device, model.dtype
        ltype = torch.long

        # ---- prefill ----
        xy = embed_prefix(model, x_tokens, y_prefix, mask_emb_idx)
        Sp = x_pad + y_pad
        x_lens = torch.tensor([x_len], dtype=torch.int32, device=dev)
        y_lens = torch.tensor([prefix_len], dtype=torch.int32, device=dev)
        attn = prefill_attention(x_lens, y_lens, x_pad, H, Sp)
        cache = trm.init_kv_cache(L, 1, s_max, H, Dh, dtype, dev)
        h, cache = trm.prefill(model.decoder, xy, attn, cache)
        h_last = h[:, x_pad + prefix_len - 1]               # [1, D]
        logits = apply_heads(model.heads, h_last)           # [1, K, card]

        scalar = lambda v, t=ltype: torch.tensor(v, dtype=t, device=dev)
        x_len_t = scalar(x_len)
        pos = scalar(x_pad + prefix_len)
        y_pos = scalar(prefix_len)
        gen_buf = torch.zeros((gen_max, K), dtype=ltype, device=dev)
        gen_cnt = scalar(0)
        codebook_eog = torch.zeros((K,), dtype=torch.bool, device=dev)
        cur_num_gen = scalar(0)
        consec = scalar(0)
        prev = scalar(-1)
        n_steps = 0

        while n_steps < gen_max:
            samples, new_eog, new_consec, new_prev = _adjust_and_sample(
                cfg, scfg, is_tts, cap_mult, generator, logits[0],
                codebook_eog, cur_num_gen, consec, prev, y_pos, x_len_t)
            done = new_eog.all()             # the one span is complete
            gen_buf.index_copy_(0, gen_cnt.view(1), samples[None])
            gen_cnt += 1
            n_steps += 1
            codebook_eog = new_eog & ~done
            cur_num_gen = torch.where(done, 0, cur_num_gen + 1)
            consec = torch.where(done, 0, new_consec)
            prev = torch.where(done, -1, new_prev)

            # feed the sample through the decoder (also after the last one,
            # as the JAX loop does)
            feed = embed_step(model, samples, y_pos)
            h, cache = trm.decode_step_fast(model.decoder, feed, cache, pos,
                                            x_len=x_len_t, x_pad=x_pad,
                                            fused_ffn=fused_ffn)
            logits = apply_heads(model.heads, h[:, 0])
            pos += 1
            y_pos += 1
            if bool(done):
                break
        return gen_buf, n_steps

    return decode
