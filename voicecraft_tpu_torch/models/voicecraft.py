"""VoiceCraft model, its training forward and its decode loops for
zero-shot TTS, multi-span editing, best-of-N TTS and verified speculative
decoding (PyTorch port of voicecraft_tpu/models/voicecraft.py).

``VoiceCraft`` holds the parameters: per-codebook audio embeddings (summed),
text and mask embeddings, sine positional embeddings scaled by learnable
alphas, the pre-norm decoder, per-codebook 2-layer GELU heads and, for
speculative decoding, ``n_mtp`` groups of multi-token-prediction heads.
The decoder is the config's block (``ModelConfig.block``): VoiceCraft's
(models/transformer.py) or DeepSeek-V2's (models/deepseek_v2.py, with a
latent slab), chosen once for the whole stack; the front end and the heads
are the same for both.
Embedding tables, alphas, norm parameters and head biases are f32, as
the JAX code reads them.  For inference every weight matrix is stored once
in the compute dtype (or weight-only fp8, utils/quantize.py); a trainable
model (``trainable=True``) keeps them in the parameter dtype, f32 master
weights cast to the compute dtype at each product.

``forward_train`` is the training forward and loss over a host-composed
``TrainBatch`` (data/spans.py): next-token CE in the delayed space on the
slots that hold a real token, weighted per codebook, with the MTP heads'
auxiliary loss.

Each decode loop keeps its state in device tensors of static shape (the
write pointer, the sampling state, the token and span buffers, the span
feed queue) and syncs with the host once per step (speculative loops: once
per verified pass).  On a CUDA device the single-stream loop replays its
step from a CUDA graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import warnings
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, block_of

from ..ops.attention import dropout, mha, segment_padding_bias
from ..ops import _native
from ..ops.flash_attention import chunked_attention, prefill_attention
from ..ops.sampling import sample
from ..parallel.mesh import (copy_to_model, gather_table_cols, reduce_data,
                             reduce_model)
from ..utils import tracing
from ..utils.quantize import dequant_dot
from . import deepseek_v2 as dsv2
from . import transformer as trm
from .embedding import sine_table

BAN = -10000.0  # the reference's in-place logit ban value

MAX_POS = 4096  # positional table size


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


class Heads(nn.Module):
    """K prediction heads Linear(D, half) -> GELU -> Linear(half, card),
    stacked along a leading K axis.  ``mesh``: the parallel.mesh.Mesh whose
    'model' axis shards the half columns (the main heads; the MTP heads
    stay replicated, as in the JAX package), else None."""

    mesh = None

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
    """``trainable``: weight matrices in ``cfg.param_dtype`` and every
    parameter requiring grad (the trainer's model); else matrices in the
    compute dtype, frozen (inference).  ``mesh``: the parallel.mesh.Mesh
    the model is sharded over (``shard_params``), else None."""

    mesh = None

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        wdtype = _DTYPES[cfg.param_dtype] if trainable else self.dtype
        K, D, f32 = cfg.n_codebooks, cfg.d_model, torch.float32
        self.text_emb = trm._param(cfg.n_text_tokens, D, dtype=f32, device=device)
        self.audio_emb = trm._param(K, cfg.card, D, dtype=f32, device=device)
        self.mask_emb = trm._param(cfg.max_n_spans, D, dtype=f32, device=device)
        self.alpha_text = trm._param(dtype=f32, device=device)
        self.alpha_audio = trm._param(dtype=f32, device=device)
        if block_of(cfg) == dsv2.BLOCK:
            require_voicecraft(cfg, "training (a trainable model)",
                               refuse=trainable)
            self.decoder = dsv2.Decoder(cfg, wdtype, device, MAX_POS)
        else:
            self.decoder = trm.Decoder(cfg.num_decoder_layers, D, cfg.nhead,
                                       cfg.ffn_dim, wdtype, device,
                                       norm=cfg.norm,
                                       activation=cfg.ffn_activation)
        self.heads = Heads(K, D, cfg.audio_vocab_size // 2, cfg.card,
                           wdtype, device)
        if cfg.n_mtp > 0:
            self.mtp_heads = _mtp_heads(cfg, wdtype, device)
        self.register_buffer("pe", torch.from_numpy(sine_table(MAX_POS, D)).to(device),
                             persistent=False)
        self.requires_grad_(trainable)

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
        # last, so that the other weights equal an n_mtp = 0 model's
        for heads in getattr(self, "mtp_heads", None) or ():
            heads.init_weights(generator)
        return self


def require_voicecraft(cfg: ModelConfig, what: str, refuse: bool = True
                       ) -> None:
    """Raise, naming the block, where ``what`` serves VoiceCraft's block
    only and the config's block is another."""
    if refuse and block_of(cfg) != "voicecraft":
        raise ValueError(f"{what} is not implemented for block "
                         f"{block_of(cfg)!r} (VoiceCraft's block only)")


def _mtp_heads(cfg: ModelConfig, dtype: torch.dtype, device) -> nn.ModuleList:
    return nn.ModuleList(
        Heads(cfg.n_codebooks, cfg.d_model, cfg.audio_vocab_size // 2,
              cfg.card, dtype, device) for _ in range(cfg.n_mtp))


def init_mtp_heads(cfg: ModelConfig, generator: torch.Generator,
                   device) -> nn.ModuleList:
    """``cfg.n_mtp`` groups of multi-token-prediction heads, each the
    2-layer GELU structure of the main heads with their init distribution;
    group j predicts the token at offset j + 2 in the delayed space (the
    main heads predict offset + 1).  Assign to ``model.mtp_heads``: they
    change none of the model's other weights."""
    heads = _mtp_heads(cfg, compute_dtype(cfg), device)
    for h in heads:
        h.init_weights(generator)
    return heads


def check_mtp_heads(model: "VoiceCraft", n_draft: int,
                    scfg: Optional["SamplingConfig"] = None) -> None:
    """Whether ``model`` can drive ``n_draft``-token speculative decoding:
    raises without MTP heads or with fewer than n_draft - 1 groups.  With
    ``scfg``, warns when exact verification meets temperature sampling,
    where a greedy draft almost never equals the sampled token."""
    if n_draft <= 1:
        return
    require_voicecraft(model.cfg, "speculative decoding")
    mtp = getattr(model, "mtp_heads", None)
    if mtp is None:
        raise ValueError("speculative decoding needs the model's mtp_heads "
                         "(a checkpoint trained with n_mtp > 0)")
    if n_draft - 1 > len(mtp):
        raise ValueError(
            f"n_draft={n_draft} needs {n_draft - 1} MTP head groups, but "
            f"the checkpoint has n_mtp={len(mtp)}")
    if (scfg is not None and scfg.temperature > 0
            and scfg.spec_sampling == "exact"):
        warnings.warn(
            f"speculative decoding (n_draft={n_draft}) with "
            f"temperature={scfg.temperature} > 0: exact-match verification "
            "of greedy drafts against sampled tokens rejects almost "
            "everything, so --spec will only add per-pass overhead.  Use "
            "temperature <= 0 (greedy), or spec_sampling='stochastic' "
            "(--spec-sampling stochastic) for distribution-exact "
            "speculative SAMPLING with real acceptance.",
            stacklevel=2)


def param_count(model: nn.Module) -> int:
    """The model's parameter count (the JAX package's ``param_count`` of
    the same preset's parameters)."""
    return sum(p.numel() for p in model.parameters())


def embed_audio_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Sum of per-codebook embeddings: table [K, card, D], tokens [B, K, T]
    -> [B, T, D] in the table's dtype (a D-sharded table's sum all-gathered
    along D)."""
    out = table[0][tokens[:, 0]]
    for k in range(1, table.shape[0]):
        out = out + table[k][tokens[:, k]]
    return gather_table_cols(out, table)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx], all-gathered along D when the table is D-sharded."""
    return gather_table_cols(table[idx], table)


def apply_heads(heads: Heads, h: torch.Tensor) -> torch.Tensor:
    """h [N, D] -> logits [N, K, card] in f32 (exact-erf GELU).  Both
    products come out in f32 (a weight-only fp8 head's scale applied in f32
    after its product); the hidden layer is rounded to h's dtype once,
    after its bias and the GELU, as in the JAX package.  Under a mesh's
    'model' axis the first layer is column-parallel and the second
    row-parallel: the f32 partial logits are summed over 'model', then b2
    is added once."""
    h1 = dequant_dot(copy_to_model(h, getattr(heads, "mesh", None))
                     .unsqueeze(0),
                     heads.w1)                                       # [K,N,half]
    h1 = F.gelu(h1 + heads.b1[:, None].float(), approximate="none")
    logits = reduce_model(dequant_dot(h1.to(h.dtype), heads.w2),
                          getattr(heads, "mesh", None))              # [K,N,card]
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
    x_in = (lookup(model.text_emb, x_tokens).to(dtype)
            + model.alpha_text.to(dtype) * pe[:x_pad])
    y_emb = embed_audio_tokens(model.audio_emb, y_prefix).to(dtype)
    mask_vecs = lookup(model.mask_emb, mask_emb_idx.clamp(min=0)).to(dtype)
    y_emb = torch.where((mask_emb_idx >= 0)[..., None], mask_vecs, y_emb)
    y_in = y_emb + model.alpha_audio.to(dtype) * pe[:y_pad]
    return torch.cat([x_in, y_in], dim=1)


def column_embedding(model: VoiceCraft, samples: torch.Tensor) -> torch.Tensor:
    """The summed embedding [D] of one delayed-space column ``samples`` [K],
    summed in f32 and rounded once to the compute dtype."""
    return embed_audio_tokens(model.audio_emb,
                              samples[None, :, None])[0, 0].to(model.dtype)


def step_input(model: VoiceCraft, emb: torch.Tensor,
               y_pos: torch.Tensor) -> torch.Tensor:
    """The decode-step input [1, 1, D]: ``emb`` [D] (compute dtype) plus the
    alpha-scaled positional term at audio position ``y_pos`` (a 0-d tensor,
    read on the device)."""
    dtype = model.dtype
    pe = model.pe.index_select(0, y_pos.view(1)).to(dtype)
    return (emb + model.alpha_audio.to(dtype) * pe)[None]


# ==============================================================================
# training forward
# ==============================================================================

class TrainBatch(NamedTuple):
    """A training batch composed on the host (data/spans.py,
    data/manifest.py:collate_train), as tensors on the model's device.

    x:            [B, Sx]    int32 text tokens (padded with text_pad_token)
    x_lens:       [B]        int32
    y_tokens:     [B, K, Sy] int32 composed delayed sequence (spans
                  rearranged, delay-interleaved, eog/eos appended, mask
                  placeholders at span joints, padded with audio_pad_token)
    y_lens:       [B]        int32 composed lengths
    mask_emb_idx: [B, Sy]    int32 mask-embedding index at mask slots, -1 else
    target_valid: [B, K, Sy] bool, True where slot p + 1 holds a real token
                  of the same span (position p's CE target mask)
    """
    x: torch.Tensor
    x_lens: torch.Tensor
    y_tokens: torch.Tensor
    y_lens: torch.Tensor
    mask_emb_idx: torch.Tensor
    target_valid: torch.Tensor


def _head_logits(heads: Heads, h: torch.Tensor) -> torch.Tensor:
    """h [B, S, D] -> f32 logits [B, K, S, card]."""
    B, S, D = h.shape
    logits = apply_heads(heads, h.reshape(B * S, D))                # [BS,K,card]
    return logits.view(B, S, *logits.shape[1:]).transpose(1, 2)


def _mtp_group_stats(heads: Heads, h: torch.Tensor, tgt: torch.Tensor,
                     valid: torch.Tensor):
    """One MTP head group: (mean CE per codebook [K], target count per
    codebook [K], top-1 hits, targets)."""
    logits = _head_logits(heads, h)
    tl = torch.log_softmax(logits, dim=-1).gather(-1, tgt[..., None])[..., 0]
    ntok = valid.sum(dim=(0, 2))
    loss_k = (-tl * valid).sum(dim=(0, 2)) / ntok.clamp(min=1)
    top1 = (logits.argmax(-1) == tgt) & valid
    return loss_k, ntok, top1.sum(), valid.sum()


def _shift(t: torch.Tensor, n: int) -> torch.Tensor:
    """t[..., n:] followed by n zero (False) columns."""
    return torch.cat([t[..., n:], torch.zeros_like(t[..., :n])], dim=-1)


def forward_train(model: VoiceCraft, batch: TrainBatch,
                  seed: Optional[int] = None, remat: bool = True) -> dict:
    """Training forward and loss (reference voicecraft.py:472-559).

    Dropout (the preset's rates) is on when ``seed`` is given, each mask
    seeded from (seed, site); ``remat`` applies ``cfg.train_remat``.
    Returns loss (sum over codebooks of mean CE x weight x target count),
    top10acc (micro, a count), top10acc_by_codebook [K], effective_ntoken
    and, with MTP heads, mtp_loss (included in loss) and mtp_top1acc
    [n_mtp].

    On a sharded model (``model.mesh``) ``batch`` is this data rank's rows:
    the loss, the counts and the MTP statistics are those of the global
    batch, summed over 'data' (the loss's backward gives each rank the
    gradient of its own rows), and the dropout masks of a data rank's rows
    are drawn from the seed folded with its data rank."""
    cfg = model.cfg
    require_voicecraft(cfg, "forward_train")
    dtype = model.dtype
    mesh = model.mesh
    B, Sx = batch.x.shape
    Sy = batch.y_tokens.shape[-1]
    pe = model.pe.to(dtype)
    if mesh is not None and mesh.n_data > 1:
        seed = trm.fold_seed(seed, mesh.n_data, mesh.data_rank)
    site = lambda i: trm.fold_seed(seed, i)
    nhead = model.decoder.nhead

    # the text and audio embeddings (reference voicecraft.py:311-320, 497-500)
    x_emb = dropout(lookup(model.text_emb, batch.x).to(dtype),
                    cfg.text_embedding_dropout, site(0))
    x_in = dropout(x_emb + model.alpha_text.to(dtype) * pe[:Sx],
                   cfg.text_positional_embedding_dropout, site(1))
    y_emb = embed_audio_tokens(model.audio_emb, batch.y_tokens).to(dtype)
    mask_vecs = lookup(model.mask_emb,
                       batch.mask_emb_idx.clamp(min=0)).to(dtype)
    y_emb = torch.where((batch.mask_emb_idx >= 0)[..., None], mask_vecs, y_emb)
    y_in = dropout(y_emb + model.alpha_audio.to(dtype) * pe[:Sy],
                   cfg.audio_positional_embedding_dropout, site(2))

    # the joint stack (reference voicecraft.py:406-470)
    policy = cfg.train_remat if remat else "none"
    if cfg.train_attn == "chunked":
        def attn(q, k, v, s):
            return chunked_attention(q, k, v, batch.x_lens, batch.y_lens, Sx,
                                     nhead)
    else:
        bias = segment_padding_bias(Sx + Sy, Sx, batch.x_lens, batch.y_lens)

        def attn(q, k, v, s):
            return mha(q, k, v, bias, nhead, cfg.trm_dropout, s)
        if policy not in ("none", "full"):
            attn = functools.partial(checkpoint, attn, use_reentrant=False)
    h = trm.apply_stack(model.decoder, torch.cat([x_in, y_in], dim=1), attn,
                        cfg.trm_dropout, site(3), policy)
    h_y = h[:, Sx:]

    # shifted, masked CE in the delayed space: target[q, p] = y[q, p + 1]
    tokens = batch.y_tokens.long()
    targets = _shift(tokens, 1)
    valid = batch.target_valid
    logits = _head_logits(model.heads, h_y)                        # [B,K,Sy,card]
    tgt_logp = torch.log_softmax(logits, dim=-1).gather(
        -1, targets[..., None])[..., 0]
    ntok_k = valid.sum(dim=(0, 2))                                  # [K]
    loss_k = (-tgt_logp * valid).sum(dim=(0, 2)) / ntok_k.clamp(min=1)
    w = torch.tensor(cfg.codebook_weight or (1.0,) * cfg.n_codebooks,
                     dtype=torch.float32, device=h.device)
    loss = (loss_k * ntok_k.float() * w).sum()

    # micro top-10 accuracy by rank (reference voicecraft.py:187-195, 541)
    tgt_logit = logits.gather(-1, targets[..., None])
    rank = (logits > tgt_logit).sum(dim=-1)
    acc_k = ((rank < 10) & valid).sum(dim=(0, 2)) / ntok_k.clamp(min=1)
    out = {"loss": reduce_data(loss, mesh),
           "top10acc_by_codebook": reduce_data((acc_k * ntok_k).detach(),
                                               mesh),
           "effective_ntoken": reduce_data(ntok_k.sum(), mesh)}
    out["top10acc"] = out["top10acc_by_codebook"].sum()

    # the MTP auxiliary loss: group j predicts offset j + 2; cell (k, p)
    # trains where the endpoint slot p + 2 + j holds a real token of the
    # span and no slot p + 1 .. p + 1 + j is a mask placeholder; one group's
    # logits live at a time (each group under a checkpoint)
    mtp = getattr(model, "mtp_heads", None)
    if mtp is not None:
        h_mtp = h_y.detach() if cfg.mtp_detach else h_y
        not_mask = (batch.mask_emb_idx < 0)[:, None, :].expand_as(valid)
        win = torch.ones_like(valid)
        mtp_loss = torch.zeros((), dtype=torch.float32, device=h.device)
        hits, counts = [], []
        for j, heads_j in enumerate(mtp):
            win = win & _shift(not_mask, 1 + j)
            valid_j = _shift(valid, 1 + j) & win
            loss_jk, ntok_j, hit_j, count_j = checkpoint(
                _mtp_group_stats, heads_j, h_mtp, _shift(tokens, 2 + j),
                valid_j, use_reentrant=False)
            mtp_loss = mtp_loss + (loss_jk * ntok_j.float() * w).sum()
            hits.append(hit_j)
            counts.append(count_j)
        out["mtp_loss"] = reduce_data(cfg.mtp_weight * mtp_loss, mesh)
        hits = reduce_data(torch.stack(hits), mesh)
        out["mtp_top1acc"] = hits / reduce_data(torch.stack(counts),
                                                mesh).clamp(min=1)
        out["loss"] = out["loss"] + out["mtp_loss"]
    return out


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
    # speculative verification (the plain loops ignore both):
    #   "exact"      accept a draft only if it equals the token the plain
    #                loop samples there; greedy output equals the plain
    #                loop's, sampled output is keyed per token index (the
    #                same for every tau)
    #   "stochastic" drafts sampled from the MTP distributions q, verified
    #                per codebook row by rejection sampling (accept with
    #                probability min(1, p/q), else draw the residual): the
    #                emitted law is exactly the plain loop's
    spec_sampling: str = "exact"
    # the draft proposal's temperature in stochastic mode (< 0: the
    # sampling temperature); any q keeps the output law exact
    spec_draft_temperature: float = -1.0


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
    penalty.  One set of tensor operations serves any number of lanes:
    logits_k [..., K, card] f32, codebook_eog [..., K] bool, and
    cur_num_gen / consec_silence / prev_token of shape [...] (0-d for one
    stream, [B] for B lanes)."""
    K, card = logits_k.shape[-2:]
    dev = logits_k.device
    eog_stop = cfg.eog_inference if is_tts else cfg.eog
    rows = torch.arange(K, device=dev)[:, None]
    cols = torch.arange(card, device=dev)[None, :]
    n_eog = codebook_eog.sum(-1)
    cell = lambda t: t[..., None, None]          # [...] -> [..., 1, 1]

    la = logits_k
    if cfg.eos > 0:
        # TTS bans eog everywhere, editing bans eos everywhere
        la = la.masked_fill(cols == (cfg.eog if is_tts else cfg.eos), BAN)
    # rows beyond the next-to-finish codebook may not emit eog/empty
    ban = (rows > cell(n_eog)) & ((cols == eog_stop) | (cols == cfg.empty_token))
    la = la.masked_fill(ban, BAN)
    if is_tts:
        min_guard = cell(cur_num_gen <= cfg.encodec_sr // 5)
        la = la.masked_fill(min_guard & (rows == 0) & (cols == eog_stop), BAN)
    if scfg.stop_repetition > 0 and len(scfg.silence_tokens) > 0:
        sil = _silence_tokens(scfg.silence_tokens, dev)
        hit = ((sil == prev_token[..., None]).any(-1)
               & (consec_silence > scfg.stop_repetition) & (n_eog == 0))
        denom = cell(consec_silence - (scfg.stop_repetition - 1)).float()
        on = cell(hit) & (rows == 0) & (cols == cell(prev_token))
        penalised = torch.where(la < 0, la * denom, la / denom.clamp(min=1.0))
        la = torch.where(on, penalised, la)
    return la


def _finalize_sample(cfg: ModelConfig, scfg: SamplingConfig, is_tts: bool,
                     cap_mult: int, la, samples, codebook_eog, cur_num_gen,
                     consec_silence, prev_token, y_pos, x_len):
    """Post-sampling machinery of the reference sample_helper twins: forced
    empties for a span's first K-1 steps, the eog stop check (which sees the
    ADJUSTED row 0), silence counters, and the eog cascade.  Shapes as
    _adjust_logits (samples [..., K]; y_pos / x_len [...]).  Returns
    (samples [..., K], codebook_eog [..., K], consec_silence, prev_token)."""
    K = la.shape[-2]
    dev = la.device
    eog_stop = cfg.eog_inference if is_tts else cfg.eog
    n_eog = codebook_eog.sum(-1)
    r = torch.arange(K, device=dev)
    lane = lambda t: t[..., None]                # [...] -> [..., 1]

    # ---- n_eog == 0: forced empties, stop check, silence counters ----
    s0 = torch.where(r > lane(cur_num_gen), cfg.empty_token, samples)
    stop_hit = ((s0[..., 0] == eog_stop) | (la[..., 0, :].argmax(-1) == eog_stop)
                | (y_pos > x_len * cap_mult))
    s0 = torch.where(r == 0, lane(torch.where(stop_hit, eog_stop, s0[..., 0])),
                     s0)
    eog0 = torch.where(r == 0, lane(stop_hit), codebook_eog)
    if len(scfg.silence_tokens) > 0:
        sil = _silence_tokens(scfg.silence_tokens, dev)
        is_sil = (sil == s0[..., :1]).any(-1) & (s0[..., 0] == prev_token)
    else:
        is_sil = torch.zeros_like(stop_hit)
    consec0 = torch.where(is_sil, consec_silence + 1, 0)
    prev0 = s0[..., 0]

    # ---- n_eog > 0: continue the eog cascade ----
    s1 = torch.where(r < lane(n_eog), cfg.empty_token, samples)
    s1 = torch.where(r == lane(n_eog), eog_stop, s1)
    eog1 = codebook_eog | (r == lane(n_eog))

    first = n_eog == 0
    return (torch.where(lane(first), s0, s1), torch.where(lane(first), eog0, eog1),
            torch.where(first, consec0, consec_silence),
            torch.where(first, prev0, prev_token))


def _adjust_and_sample(cfg: ModelConfig, scfg: SamplingConfig, is_tts: bool,
                       cap_mult: int, generator, logits_k, codebook_eog,
                       cur_num_gen, consec_silence, prev_token, y_pos, x_len,
                       raw_override=None, bench_mode: bool = False):
    """One sampling decision per lane: logit adjustments, a draw, then the
    deterministic finalisation.  logits_k [..., K, card] f32 with the state
    shapes of _adjust_logits; ``generator`` is one generator, or one per
    lane (ops.sampling.uniform: each lane's noise from its own).

    ``raw_override=(use [...], tokens [..., K])`` substitutes a
    predetermined raw sample for the draw where ``use`` (the stochastic
    verifier's pending corrected token); the finalisation is the same
    either way.  ``bench_mode`` (measurement) never stops: no codebook
    finishes and special codes become 0, so a decode runs to its budget."""
    la = _adjust_logits(cfg, scfg, is_tts, logits_k, codebook_eog,
                        cur_num_gen, consec_silence, prev_token)
    samples = sample(generator, la, scfg.top_k, scfg.top_p, scfg.temperature)
    if raw_override is not None:
        use, tokens = raw_override
        samples = torch.where(use[..., None], tokens, samples)
    out = _finalize_sample(cfg, scfg, is_tts, cap_mult, la, samples,
                           codebook_eog, cur_num_gen, consec_silence,
                           prev_token, y_pos, x_len)
    return _bench(cfg, *out) if bench_mode else out


def _bench(cfg: ModelConfig, samples, eog, consec, prev):
    """bench_mode's rewrite of a finalised decision (the JAX loops'): no
    codebook finishes, and special codes (>= audio_vocab_size) become 0."""
    return (torch.where(samples >= cfg.audio_vocab_size, 0, samples),
            torch.zeros_like(eog), consec, prev)


# ==============================================================================
# decode loops
# ==============================================================================

def kv_cache_dtype(model: VoiceCraft, kv_dtype: Optional[str]) -> torch.dtype:
    """The slab's dtype: the compute dtype, or float8_e4m3fn for
    ``kv_dtype="float8_e4m3fn"`` (the slab in fp8, upcast per layer where
    it is read, as the JAX loops' ``kv_dtype``)."""
    if kv_dtype is None:
        return model.dtype
    require_voicecraft(model.cfg, f"a kv_dtype of {kv_dtype!r}")
    if kv_dtype != "float8_e4m3fn":
        raise ValueError(f"kv_dtype {kv_dtype!r} is not supported "
                         "(None or 'float8_e4m3fn')")
    return torch.float8_e4m3fn


def new_kv_cache(model: VoiceCraft, batch: int, s_max: int,
                 kv_dtype: Optional[str] = None) -> torch.Tensor:
    """The one slab constructor, for the model's block: VoiceCraft's
    [L, 2, B, S_max, H, Dh] (H this rank's heads) in the ``kv_dtype`` slab
    dtype, or DeepSeek-V2's latent slab [L, B, S_max, r + dr]."""
    cfg, dec = model.cfg, model.decoder
    dtype = kv_cache_dtype(model, kv_dtype)
    if block_of(cfg) == dsv2.BLOCK:
        return dsv2.init_latent_cache(cfg.num_decoder_layers, batch, s_max,
                                      dec.latent_dim, dtype, model.device)
    return trm.init_kv_cache(cfg.num_decoder_layers, batch, s_max, dec.nhead,
                             cfg.head_dim, dtype, model.device)


def slab_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(lane dim, slot dim) of the model's slab (:func:`new_kv_cache`)."""
    return (1, 2) if block_of(cfg) == dsv2.BLOCK else (2, 3)


def prefill_lanes(model: VoiceCraft, x_tokens, x_lens, y_prefix, prefix_lens,
                  mask_emb_idx, s_max: int, kv_dtype: Optional[str] = None):
    """The prefill of B lanes: the embedded prefixes [B, Sp, D] (inputs of
    one prompt broadcast to B), one forward that fills a new slab of
    ``s_max`` slots in the ``kv_dtype`` slab dtype (attention through
    ops.flash_attention.prefill_attention, with each lane's text and prompt
    lengths), and the heads at each lane's last prefix column.

    x_tokens [B or 1, x_pad], y_prefix [B or 1, K, y_pad], mask_emb_idx
    [B or 1, y_pad]; x_lens / prefix_lens: int32 [B] on the model's device.
    Returns (h_last [B, D], logits [B, K, card] f32, cache)."""
    cfg = model.cfg
    x_pad, y_pad = x_tokens.shape[1], y_prefix.shape[2]
    B = x_lens.shape[0]
    xy = embed_prefix(model, x_tokens, y_prefix, mask_emb_idx).expand(B, -1, -1)
    cache = new_kv_cache(model, B, s_max, kv_dtype)
    if block_of(cfg) == dsv2.BLOCK:
        h, cache = dsv2.prefill(model.decoder, xy, x_lens, prefix_lens, x_pad,
                                cache)
    else:
        attn = prefill_attention(x_lens, prefix_lens, x_pad,
                                 model.decoder.nhead, x_pad + y_pad)
        h, cache = trm.prefill(model.decoder, xy, attn, cache)
    last = (x_pad + prefix_lens - 1).long()
    h_last = h[torch.arange(B, device=h.device), last]          # [B, D]
    return h_last, apply_heads(model.heads, h_last), cache


def prefill_prompt(model: VoiceCraft, x_tokens, x_len: int, y_prefix,
                   prefix_len: int, mask_emb_idx, s_max: int, batch: int = 1,
                   kv_dtype: Optional[str] = None):
    """prefill_lanes of one prompt for ``batch`` decode paths.  Returns
    (h_last [batch, D], logits [batch, K, card] f32, cache)."""
    lens = lambda v: torch.full((batch,), v, dtype=torch.int32,
                                device=model.device)
    return prefill_lanes(model, x_tokens, lens(x_len), y_prefix,
                         lens(prefix_len), mask_emb_idx, s_max, kv_dtype)


@dataclasses.dataclass
class DecodeResult:
    """What one decode run leaves: the recorded samples and, from the last
    host sync, the counts."""
    gen_buf: torch.Tensor     # [gen_max, K] delayed-space samples (device)
    span_buf: torch.Tensor    # [gen_max] span index of each sample (device)
    gen_cnt: int              # recorded samples (rows of gen_buf in use)
    spans_done: int           # spans started (the JAX loop's span_idx + 1)
    forwards: int             # decoder forwards, feed steps included
    idle: int = 0             # forwards after the decode ended (the trailing
                              # sub-steps of steps_per_iter > 1)
    logits: Optional[torch.Tensor] = None  # the last forward's heads, f32
                                           # [1, K, card] (device)


def step_graph_engages(model: VoiceCraft) -> bool:
    """Whether make_decode_loop replays its decode step from a CUDA graph:
    the model's tensors are on a CUDA device and its decoder is not split
    over a mesh's 'model' axis (a split step runs collectives, which are
    not captured).  Either block: DeepSeek-V2's expert layers route with
    no host sync and no shape taken from the routing (ops/moe.py)."""
    mesh = getattr(model.decoder, "mesh", None)
    return (model.device.type == "cuda"
            and not (mesh is not None and mesh.n_model > 1))


_sites = threading.local()


class _CaptureSite:
    """This thread's place on one device to capture decode steps: a stream
    other than the default one, which a capture needs (a decode's first
    step runs there too, and so settles what the capture then reuses:
    cuBLAS's workspace for that stream, the FFN kernel's attributes, cached
    constants), and the graph captured there last, kept so that the next
    capture shares its memory pool.  A capture into a pool of its own
    leaves that pool reserved until a cudaMalloc fails (a 2 MiB segment a
    decode)."""

    def __init__(self, idx: int):
        self.idx = idx
        self.stream = torch.cuda.Stream(idx)
        self.last: Optional["torch.cuda.CUDAGraph"] = None

    @staticmethod
    def of(device: torch.device) -> "_CaptureSite":
        sites = getattr(_sites, "by_device", None)
        if sites is None:
            sites = _sites.by_device = {}
        idx = (torch.cuda.current_device() if device.index is None
               else device.index)
        if idx not in sites:
            sites[idx] = _CaptureSite(idx)
        return sites[idx]

    @contextlib.contextmanager
    def running(self):
        """Run the block on the site's stream, ordered after the work
        queued on the current stream and before the work queued there
        after it."""
        main = torch.cuda.current_stream(self.idx)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)


class _StepGraph:
    """One decode step captured in a CUDA graph.  The capture runs nothing;
    each replay runs the step's kernels in the captured order on the state
    tensors the capture saw, and draws from ``generator`` (registered with
    the graph) where the eager step draws: every replay advances its Philox
    offset as an eager step does.  The fused FFN's launch counts move from
    the capture to the replays (ops/_native.py:GraphLaunches)."""

    def __init__(self, step, generator: Optional[torch.Generator],
                 device: torch.device):
        site = _CaptureSite.of(device)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        pool = None if site.last is None else site.last.pool()
        with site.running(), _native.GraphLaunches() as self.launches:
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                step()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        site.last = self.graph

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replayed()


def make_decode_loop(cfg: ModelConfig, *, is_tts: bool, x_pad: int,
                     y_pad: int, gen_max: int, scfg: SamplingConfig,
                     max_spans: Optional[int] = None,
                     bench_mode: bool = False, fused_ffn: bool = False,
                     kv_dtype: Optional[str] = None, steps_per_iter: int = 1):
    """The single-sample decode function for one geometry: TTS (one span)
    or multi-span editing.

    Static geometry: x padded to ``x_pad``, the composed y prefix padded to
    ``y_pad``, at most ``gen_max`` recorded samples, at most ``max_spans``
    spans (default ``cfg.max_n_spans``).  When a span completes and spans
    remain, a 2-deep queue feeds [mask embedding of the next span, empty
    column] through the decoder.  Those feed steps advance ``pos`` and
    ``y_pos`` but record nothing and do not count against ``gen_max``, so
    the slab has 2 * (max_spans - 1) extra slots.  Every step draws (a feed
    step's draw is thrown away), so each step of a decode runs the same
    ops; the queue, the per-span resets and the span bookkeeping are device
    tensors under ``torch.where``.  A one-span decode (TTS) can never queue
    a feed and leaves that bookkeeping out (~30 fewer launches per step).

    A step is one function that updates that state in place, the sampling
    logits and the counts the host reads included.  Where
    :func:`step_graph_engages` (a CUDA model), the first step runs eagerly
    and the second captures the step in a CUDA graph, which every later
    step replays (:class:`_StepGraph`): the same kernels on the same data,
    and the same draws from ``generator``, with one launch a step from the
    host.  Elsewhere every step runs eagerly.

    ``steps_per_iter`` = k runs k steps between host syncs, each of which
    reads ``done``, the sample count and the span index together (k = 1:
    one sync a step).  With k > 1 every step is gated on ``active`` (not
    done and under the budget): a step after the end still runs the
    forward, writing its k/v at the frozen ``pos`` (the next free slot,
    clamped into the slab as JAX's dynamic_update_slice clamps it; no
    active step reads it, since a decode never becomes active again) and
    its samples past the recorded count (a spare row covers a full
    budget), and leaves the bookkeeping as it was.  Its draws come after
    the last recorded sample, so the output equals k = 1's token for
    token.  The slab keeps k = 1's size (JAX's has k - 1 more slots): its
    products keep their shapes, so on the card too every active step
    computes k = 1's logits bit for bit.  At most k - 1 forwards are
    wasted (``DecodeResult.idle``).

    ``bench_mode`` (measurement) never stops a span: the decode records
    exactly ``gen_max`` samples, with special codes mapped to 0.
    ``kv_dtype`` (e.g. ``"float8_e4m3fn"``) stores the slab in that dtype.

    Returns decode(model, x_tokens [1, x_pad], x_len, y_prefix [1, K, y_pad],
    prefix_len, mask_emb_idx [1, y_pad], queue_mask_ids [max_spans],
    n_spans, generator) -> DecodeResult.
    """
    K = cfg.n_codebooks
    cap_mult = (cfg.encodec_sr // 5) if is_tts else 10
    if max_spans is None:
        max_spans = cfg.max_n_spans
    if steps_per_iter < 1:
        raise ValueError(f"steps_per_iter {steps_per_iter} < 1")
    grouped = steps_per_iter > 1
    s_max = x_pad + y_pad + gen_max + 2 * (max_spans - 1)

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_len: int, y_prefix,
               prefix_len: int, mask_emb_idx, queue_mask_ids, n_spans: int,
               generator: Optional[torch.Generator]) -> DecodeResult:
        if not 1 <= n_spans <= max_spans:
            raise ValueError(f"n_spans {n_spans} outside [1, max_spans "
                             f"{max_spans}] (the slab holds the feeds of "
                             "max_spans - 1 span transitions; max_spans "
                             "defaults to max_n_spans)")
        dev, dtype = model.device, model.dtype
        ltype = torch.long
        if fused_ffn:
            require_voicecraft(model.cfg, "the fused FFN")
        latent = block_of(model.cfg) == dsv2.BLOCK

        with tracing.span("decode.prefill"):
            _, logits, cache = prefill_prompt(model, x_tokens, x_len,
                                              y_prefix, prefix_len,
                                              mask_emb_idx, s_max,
                                              kv_dtype=kv_dtype)

        scalar = lambda v, t=ltype: torch.tensor(v, dtype=t, device=dev)
        x_len_t = scalar(x_len)
        pos = scalar(x_pad + prefix_len)
        y_pos = scalar(prefix_len)
        # grouped steps write past the budget: one spare row
        gen_buf = torch.zeros((gen_max + grouped, K), dtype=ltype, device=dev)
        span_buf = torch.zeros((gen_max + grouped,), dtype=ltype, device=dev)
        # what the host reads at a sync: done (0 / 1), the recorded
        # samples, the span index and the idle forwards
        counts = torch.zeros((4,), dtype=ltype, device=dev)
        done, gen_cnt, span_idx, idle = (counts[i] for i in range(4))
        codebook_eog = torch.zeros((K,), dtype=torch.bool, device=dev)
        cur_num_gen = scalar(0)
        consec = scalar(0)
        prev = scalar(-1)
        queue = torch.zeros((2, cfg.d_model), dtype=dtype, device=dev)
        queue_len = scalar(0)
        queue_mask_ids = queue_mask_ids.to(device=dev, dtype=ltype)
        empty_emb = column_embedding(
            model, torch.full((K,), cfg.empty_token, dtype=ltype, device=dev))
        multi = n_spans > 1

        def step(sample_span: bool) -> None:
            """One decode step from ``logits``: draw, record, feed the
            decoder, and write the next ``logits``, all in place.
            ``sample_span`` records the draw as ``decode.sample``."""
            if grouped:
                active = (done == 0) & (gen_cnt < gen_max)
            with (tracing.span("decode.sample") if sample_span
                  else contextlib.nullcontext()):
                samples, new_eog, new_consec, new_prev = _adjust_and_sample(
                    cfg, scfg, is_tts, cap_mult, generator, logits[0],
                    codebook_eog, cur_num_gen, consec, prev, y_pos, x_len_t,
                    bench_mode=bench_mode)
            gen_buf.index_copy_(0, gen_cnt.view(1), samples[None])
            emb = column_embedding(model, samples)
            if not multi and not grouped:
                # one span: its completion ends the loop after this step, so
                # nothing is reset
                done.copy_(new_eog.all())
                gen_cnt.add_(1)
                codebook_eog.copy_(new_eog)
                cur_num_gen.add_(1)
                consec.copy_(new_consec)
                prev.copy_(new_prev)
            elif not multi:
                done.bitwise_or_(new_eog.all() & active)
                gen_cnt.add_(active.long())
                codebook_eog.copy_(torch.where(active, new_eog, codebook_eog))
                cur_num_gen.add_(active.long())
                consec.copy_(torch.where(active, new_consec, consec))
                prev.copy_(torch.where(active, new_prev, prev))
            else:
                # a feed step records nothing and leaves the sampling state
                # alone (as does an inactive step); the row it wrote at
                # gen_cnt lies past the recorded count, and the next sample
                # overwrites it
                feeding = queue_len > 0
                span_complete = new_eog.all() & ~feeding
                if grouped:
                    span_complete = span_complete & active
                    consume, keep = feeding & active, feeding | ~active
                else:
                    consume, keep = feeding, feeding
                span_buf.index_copy_(0, gen_cnt.view(1), span_idx.view(1))
                gen_cnt.add_((~keep).long())
                emb = torch.where(feeding, queue[0], emb)

                # on a span's completion with spans left, queue [mask
                # embedding of the next span, empty column]; a feed step
                # pops the queue
                more = span_idx + 1 < n_spans
                start_next = span_complete & more
                next_id = queue_mask_ids.index_select(
                    0, (span_idx + 1).clamp(max=max_spans - 1).view(1))
                new_queue = torch.cat([lookup(model.mask_emb, next_id).to(dtype),
                                       empty_emb[None]])
                queue.copy_(torch.where(
                    start_next, new_queue,
                    torch.where(consume, queue[1].expand(2, -1), queue)))
                queue_len.copy_(torch.where(
                    start_next, 2,
                    torch.where(consume, queue_len - 1, queue_len)))
                ended = span_complete & ~more
                if grouped:
                    done.bitwise_or_(ended)
                else:
                    done.copy_(ended)
                span_idx.add_(start_next.long())

                # per-span resets
                codebook_eog.copy_(torch.where(
                    span_complete, False,
                    torch.where(keep, codebook_eog, new_eog)))
                cur_num_gen.copy_(torch.where(
                    span_complete, 0,
                    torch.where(keep, cur_num_gen, cur_num_gen + 1)))
                consec.copy_(torch.where(
                    span_complete, 0, torch.where(keep, consec, new_consec)))
                prev.copy_(torch.where(span_complete, -1,
                                       torch.where(keep, prev, new_prev)))

            # feed the step's input through the decoder (also after the last
            # sample, as the JAX loop does); an idle step's frozen pos may be
            # the slot past the slab
            at = pos.clamp(max=s_max - 1) if grouped else pos
            if latent:
                h, _ = dsv2.decode_step(
                    model.decoder, step_input(model, emb, y_pos), cache, at,
                    (x_len_t + y_pos).clamp(max=MAX_POS - 1), x_len=x_len_t,
                    x_pad=x_pad)
            else:
                h, _ = trm.decode_step_fast(
                    model.decoder, step_input(model, emb, y_pos), cache, at,
                    x_len=x_len_t, x_pad=x_pad, fused_ffn=fused_ffn)
            logits.copy_(apply_heads(model.heads, h[:, 0]))
            if grouped:
                pos.add_(active.long())
                y_pos.add_(active.long())
                idle.add_((~active).long())
            else:
                pos.add_(1)
                y_pos.add_(1)

        graphed = step_graph_engages(model)
        graph, forwards = None, 0
        while True:
            for _ in range(steps_per_iter):
                if graphed and forwards == 1:
                    with tracing.span("decode.capture"):
                        graph = _StepGraph(lambda: step(False), generator, dev)
                with tracing.span("decode.step"):
                    if graph is not None:
                        with tracing.span("decode.replay"):
                            graph.replay()
                    elif graphed:
                        with _CaptureSite.of(dev).running():
                            step(False)
                    else:
                        step(True)
                forwards += 1
            with tracing.span("decode.sync"):
                is_done, n_gen, n_span, n_idle = counts.tolist()
            if is_done or n_gen >= gen_max:
                break
        return DecodeResult(gen_buf[:gen_max], span_buf[:gen_max], n_gen,
                            n_span + 1, forwards, n_idle, logits)

    return decode


# ==============================================================================
# verified speculative decoding with multi-token-prediction drafts
# ==============================================================================

@dataclasses.dataclass
class SpecResult:
    """What one speculative decode leaves (counts from the last host
    sync)."""
    gen_buf: torch.Tensor     # [gen_max + tau, K] delayed-space samples
    span_buf: Optional[torch.Tensor]  # [gen_max + tau] span indices (edits)
    gen_cnt: int              # recorded samples
    spans_done: int           # spans started
    passes: int               # block forwards, feed passes included
    feeds: int                # feed passes (editing)


def make_spec_decode_loop(cfg: ModelConfig, *, x_pad: int, y_pad: int,
                          gen_max: int, scfg: SamplingConfig, n_draft: int,
                          bench_mode: bool = False, force_accept: bool = False,
                          kv_dtype: Optional[str] = None):
    """Verified speculative TTS decode.

    Each pass feeds ``n_draft`` = tau tokens through ONE forward
    (trm.decode_step_block): the true next token, sampled from the main
    heads as the plain loop samples it, plus tau - 1 drafts of the MTP
    heads.  The pass's own logits then re-derive what the plain loop would
    have emitted at each drafted slot, and a draft is accepted only where
    it matches (inference/spec_common.spec_verify_pass).  Greedy output
    equals the plain loop's (exactly in f32; in bf16 the block's other
    summation order can flip an argmax at a near-tie).  Sampled draws are
    keyed per token index, so sampled output is the same for every tau,
    though not the plain loop's (whose generator runs sequentially).

    ``force_accept`` (measurement): every draft is accepted, so each pass
    retires tau tokens (the drafts are emitted): the ceiling of the
    machinery at 100% acceptance.  ``bench_mode`` (measurement) never
    stops: the decode records exactly ``gen_max`` samples.  ``kv_dtype``
    stores the slab in that dtype.  The slab has s_max = x_pad + y_pad +
    gen_max + tau slots; one host sync per pass.

    Returns decode(model, x_tokens [1, x_pad], x_len, y_prefix [1, K,
    y_pad], prefix_len, mask_emb_idx [1, y_pad], seed) -> SpecResult.
    """
    from ..inference.spec_common import (make_lane_sampler, spec_verify_pass,
                                         token_generators)
    if n_draft < 1:
        raise ValueError(f"n_draft must be >= 1, got {n_draft}")
    K = cfg.n_codebooks
    cap_mult = cfg.encodec_sr // 5
    tau = n_draft
    s_max = x_pad + y_pad + gen_max + tau
    sample_lanes = make_lane_sampler(cfg, scfg, cap_mult)

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_len: int, y_prefix,
               prefix_len: int, mask_emb_idx, seed: int) -> SpecResult:
        check_mtp_heads(model, tau)
        dev = model.device
        ltype = torch.long
        h, logits, cache = prefill_prompt(model, x_tokens, x_len, y_prefix,
                                          prefix_len, mask_emb_idx, s_max,
                                          kv_dtype=kv_dtype)
        h = h.float()
        vec = lambda v, t=ltype: torch.tensor([v], dtype=t, device=dev)
        x_lens = vec(x_len)
        pos = torch.tensor(x_pad + prefix_len, device=dev)
        y_pos = vec(prefix_len)
        gen_buf = torch.zeros((gen_max + tau, K), dtype=ltype, device=dev)
        eog = torch.zeros((1, K), dtype=torch.bool, device=dev)
        cng, consec, prev = vec(0), vec(0), vec(-1)
        pending = torch.zeros((1, K), dtype=ltype, device=dev)
        has_pending = vec(False, torch.bool)
        gate = vec(True, torch.bool)
        gens = token_generators(scfg, seed, dev)
        t = passes = 0

        def forward(feed):
            return trm.decode_step_block(model.decoder, feed, cache, pos,
                                         x_len=x_lens[0], x_pad=x_pad)[0]

        while True:
            out = spec_verify_pass(
                model, cfg, sample_lanes, tau=tau, gate=gate,
                tok_gen=lambda i, salt, t=t: gens(t + i, salt), y_pos0=y_pos,
                x_lens=x_lens, logits=logits, h=h, eog=eog, cng=cng,
                consec=consec, prev=prev, t=t, accept_cap=gen_max,
                forward=forward, bench_mode=bench_mode,
                force_accept=force_accept, scfg=scfg, is_tts=True,
                cap_mult=cap_mult, pending=pending, has_pending=has_pending)
            n_acc = out["n_acc"]
            gen_buf[t:t + tau] = out["blk"][0]
            pos += n_acc[0]
            y_pos = y_pos + n_acc
            eog, cng, consec, prev = (out["eog"], out["cng"], out["consec"],
                                      out["prev"])
            logits, h = out["logits_next"], out["h_next"]
            pending, has_pending = out["pending"], out["has_pending"]
            passes += 1
            n, done = torch.stack([n_acc[0], eog.all().long()]).tolist()
            t += n
            if done or t >= gen_max:
                break
        return SpecResult(gen_buf, None, t, 1, passes, 0)

    return decode


def make_spec_edit_loop(cfg: ModelConfig, *, x_pad: int, y_pad: int,
                        gen_max: int, scfg: SamplingConfig, n_draft: int,
                        max_spans: Optional[int] = None):
    """Verified speculative multi-span editing decode.

    make_spec_decode_loop's verification (greedy output equal to the plain
    editing loop's in f32, sampled output keyed per token index) with the
    span machinery: when the eog cascade completes a span mid-block, the
    rest of the block is rejected (the verify core's ``alive``), and the
    NEXT pass is a FEED pass.  The two queued embeddings (the next span's
    mask embedding, the empty column) ride a tau-wide block with the verify
    core gated off; the write pointer advances 2, the tau - 2 tail slots
    are masked garbage, and the next pass starts from the block's RAW
    outputs at slot 1 (the empty column's logits, as in the plain loop).
    ``n_draft`` must be >= 2 for a feed pass to fit in one block.  The slab
    has s_max = x_pad + y_pad + gen_max + tau + 2 (max_spans - 1) slots
    (``max_spans``: cfg.max_n_spans unless given); one host sync per pass.

    Returns decode(model, x_tokens [1, x_pad], x_len, y_prefix [1, K,
    y_pad], prefix_len, mask_emb_idx [1, y_pad], queue_mask_ids
    [max_spans], n_spans, seed) -> SpecResult.
    """
    from ..inference.spec_common import (make_lane_sampler, spec_verify_pass,
                                         token_generators)
    if n_draft < 2:
        raise ValueError("speculative editing needs n_draft >= 2 (a feed "
                         "pass carries two embeddings)")
    K, D = cfg.n_codebooks, cfg.d_model
    cap_mult = 10
    tau = n_draft
    max_spans = max_spans or cfg.max_n_spans
    s_max = x_pad + y_pad + gen_max + tau + 2 * (max_spans - 1)
    sample_lanes = make_lane_sampler(cfg, scfg, cap_mult, is_tts=False)

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_len: int, y_prefix,
               prefix_len: int, mask_emb_idx, queue_mask_ids, n_spans: int,
               seed: int) -> SpecResult:
        if not 1 <= n_spans <= max_spans:
            raise ValueError(f"n_spans {n_spans} outside [1, max_spans "
                             f"{max_spans}]")
        check_mtp_heads(model, tau)
        dev, dtype = model.device, model.dtype
        ltype = torch.long
        h, logits, cache = prefill_prompt(model, x_tokens, x_len, y_prefix,
                                          prefix_len, mask_emb_idx, s_max)
        h = h.float()
        vec = lambda v, t=ltype: torch.tensor([v], dtype=t, device=dev)
        x_lens = vec(x_len)
        pos = torch.tensor(x_pad + prefix_len, device=dev)
        y_pos = vec(prefix_len)
        gen_buf = torch.zeros((gen_max + tau, K), dtype=ltype, device=dev)
        span_buf = torch.zeros((gen_max + tau,), dtype=ltype, device=dev)
        eog = torch.zeros((1, K), dtype=torch.bool, device=dev)
        cng, consec, prev = vec(0), vec(0), vec(-1)
        pending = torch.zeros((1, K), dtype=ltype, device=dev)
        has_pending = vec(False, torch.bool)
        span_idx = torch.tensor(0, device=dev)
        queue = torch.zeros((2, D), dtype=dtype, device=dev)
        queue_mask_ids = queue_mask_ids.to(device=dev, dtype=ltype)
        empty_emb = column_embedding(
            model, torch.full((K,), cfg.empty_token, dtype=ltype, device=dev))
        tail = torch.zeros((tau - 2, D), dtype=dtype, device=dev)
        gens = token_generators(scfg, seed, dev)
        t = passes = feeds = 0
        feeding = False

        def forward(feed):
            return trm.decode_step_block(model.decoder, feed, cache, pos,
                                         x_len=x_lens[0], x_pad=x_pad)[0]

        while True:
            # a feed pass: [mask embedding of the next span, empty column,
            # masked garbage] in place of the token embeddings, the verify
            # core gated off
            feed_emb = torch.cat([queue, tail])
            mix = (lambda e: feed_emb[None].expand_as(e)) if feeding else None
            out = spec_verify_pass(
                model, cfg, sample_lanes, tau=tau,
                gate=vec(not feeding, torch.bool),
                tok_gen=lambda i, salt, t=t: gens(t + i, salt), y_pos0=y_pos,
                x_lens=x_lens, logits=logits, h=h, eog=eog, cng=cng,
                consec=consec, prev=prev, t=t, accept_cap=gen_max,
                forward=forward, mix_emb=mix, scfg=scfg, is_tts=False,
                cap_mult=cap_mult, pending=pending, has_pending=has_pending)
            n_acc = out["n_acc"][0]             # 0 on a feed pass
            eog_f = out["eog"]
            if not feeding:
                gen_buf[t:t + tau] = out["blk"][0]
                span_buf[t:t + tau] = span_idx

            # span transitions
            span_complete = eog_f.all() & (not feeding)
            more = span_idx + 1 < n_spans
            start_next = span_complete & more
            next_id = queue_mask_ids.index_select(
                0, (span_idx + 1).clamp(max=max_spans - 1))
            new_queue = torch.cat(
                [lookup(model.mask_emb, next_id).to(dtype),
                 empty_emb[None]])
            queue = torch.where(start_next, new_queue, queue)
            done = span_complete & ~more
            span_idx = span_idx + start_next.long()
            # per-span resets (a feed pass's verify core left the state as
            # it was)
            eog = torch.where(span_complete, False, eog_f)
            cng = torch.where(span_complete, 0, out["cng"])
            consec = torch.where(span_complete, 0, out["consec"])
            prev = torch.where(span_complete, -1, out["prev"])
            pending, has_pending = out["pending"], out["has_pending"]

            # the next pass starts from the RAW block outputs: after a feed
            # pass, the second feed's (the empty column's)
            n_adv = torch.tensor(2, device=dev) if feeding else n_acc
            last = (n_adv - 1).view(1)
            logits = out["logits_blk"][0].index_select(0, last)
            h = out["h_blk"][0].index_select(0, last).float()
            pos += n_adv
            y_pos = y_pos + n_adv
            passes += 1
            feeds += feeding
            n, is_done, queued = torch.stack(
                [n_acc, done.long(), start_next.long()]).tolist()
            t += n
            feeding = bool(queued)
            if is_done or t >= gen_max:
                break
        return SpecResult(gen_buf, span_buf, t, int(span_idx) + 1, passes,
                          feeds)

    return decode


# ==============================================================================
# best-of-N TTS
# ==============================================================================

def _batch_adjust_and_sample(cfg: ModelConfig, scfg: SamplingConfig,
                             cap_mult: int, generator, logits, codebook_eog,
                             cur_num_gen, consec, prev, y_pos, x_len, keep):
    """The sampling decision of N paths over one prompt (logits [N, K,
    card] f32; consec / prev [N]; the rest 0-d, codebook_eog [K] shared by
    all paths).  As the JAX package's (and the reference's) batch sampler:
    the eos ban; the min-length guard bans eog on ALL codebooks; one global
    codebook_eog; ``keep`` becomes the HIGHEST path index that stops in the
    step (the reference loops over paths and the last hit wins); and the
    eog cascade then runs on the keep path only.  Returns (samples [N, K],
    codebook_eog, consec, prev, keep)."""
    B, K, card = logits.shape
    dev = logits.device
    eog_stop = cfg.eog_inference
    rows = torch.arange(K, device=dev)[None, :, None]
    cols = torch.arange(card, device=dev)[None, None, :]
    n_eog = codebook_eog.sum()
    first = n_eog == 0

    la = logits
    if cfg.eos > 0:
        la = la.masked_fill(cols == cfg.eog, BAN)
    la = la.masked_fill((rows > n_eog) & ((cols == eog_stop)
                                          | (cols == cfg.empty_token)), BAN)
    min_guard = first & (cur_num_gen <= cfg.encodec_sr // 5)
    la = la.masked_fill(min_guard & (cols == eog_stop), BAN)
    if scfg.stop_repetition > 0 and len(scfg.silence_tokens) > 0:
        sil = _silence_tokens(scfg.silence_tokens, dev)
        hit = ((sil[None, :] == prev[:, None]).any(dim=1)
               & (consec > scfg.stop_repetition) & first)            # [N]
        denom = (consec - (scfg.stop_repetition - 1)).float()[:, None, None]
        cell = (rows == 0) & (cols == prev[:, None, None])
        pen = torch.where(la < 0, la * denom, la / denom.clamp(min=1.0))
        la = torch.where(hit[:, None, None] & cell, pen, la)

    samples = sample(generator, la, scfg.top_k, scfg.top_p, scfg.temperature)
    r = torch.arange(K, device=dev)

    # ---- n_eog == 0 ----
    s0 = torch.where(r[None, :] > cur_num_gen, cfg.empty_token, samples)
    stop_b = ((s0[:, 0] == eog_stop) | (la[:, 0].argmax(dim=-1) == eog_stop)
              | (y_pos > x_len * cap_mult))                          # [N]
    s0 = torch.where(r[None, :] == 0,
                     torch.where(stop_b, eog_stop, s0[:, 0])[:, None], s0)
    any_stop = stop_b.any()
    last_hit = torch.where(stop_b, torch.arange(B, device=dev), -1).max()
    keep0 = torch.where(any_stop, last_hit, keep)
    eog0 = torch.where(r == 0, any_stop, codebook_eog)
    if len(scfg.silence_tokens) > 0:
        sil = _silence_tokens(scfg.silence_tokens, dev)
        is_sil = ((sil[None, :] == s0[:, :1]).any(dim=1)
                  & (s0[:, 0] == prev))
    else:
        is_sil = torch.zeros((B,), dtype=torch.bool, device=dev)
    consec0 = torch.where(is_sil, consec + 1, 0)
    prev0 = s0[:, 0]

    # ---- n_eog > 0: the cascade, on the keep path only ----
    kk = keep.clamp(min=0).view(1)
    keep_row = torch.where(r < n_eog, cfg.empty_token,
                           samples.index_select(0, kk)[0])
    keep_row = torch.where(r == n_eog, eog_stop, keep_row)
    s1 = samples.index_copy(0, kk, keep_row[None])
    eog1 = codebook_eog | (r == n_eog)

    return (torch.where(first, s0, s1), torch.where(first, eog0, eog1),
            torch.where(first, consec0, consec),
            torch.where(first, prev0, prev), torch.where(first, keep0, keep))


@dataclasses.dataclass
class BatchResult:
    """What one best-of-N decode leaves (counts from the last host sync)."""
    gen_buf: torch.Tensor     # [gen_max, N, K] delayed-space samples
    gen_cnt: int              # decode steps taken (rows of gen_buf in use)
    keep: int                 # the path returned
    forwards: int             # decoder forwards


def make_batch_tts_loop(cfg: ModelConfig, *, batch_size: int, x_pad: int,
                        y_pad: int, gen_max: int, scfg: SamplingConfig):
    """Best-of-N TTS: N sampling paths over one prompt, the one that stops
    first returned.  The prompt is prefilled once for all N paths ([N, Sp,
    D] through prefill_attention: the attention kernel at B = N from Sp >=
    1024); each step runs decode_step_fast at B = N with the unfused FFN,
    as the JAX loop does.  The state lives on the device, with one host
    sync per step.

    Returns decode(model, x_tokens [1, x_pad], x_len, y_prefix [1, K,
    y_pad], prefix_len, mask_emb_idx [1, y_pad], generator) ->
    BatchResult.
    """
    K = cfg.n_codebooks
    B = batch_size
    cap_mult = cfg.encodec_sr // 5
    s_max = x_pad + y_pad + gen_max

    @torch.inference_mode()
    def decode(model: VoiceCraft, x_tokens, x_len: int, y_prefix,
               prefix_len: int, mask_emb_idx,
               generator: Optional[torch.Generator]) -> BatchResult:
        require_voicecraft(model.cfg, "best-of-N TTS")
        dev, dtype = model.device, model.dtype
        ltype = torch.long
        _, logits, cache = prefill_prompt(model, x_tokens, x_len, y_prefix,
                                          prefix_len, mask_emb_idx, s_max,
                                          batch=B)
        scalar = lambda v: torch.tensor(v, dtype=ltype, device=dev)
        x_len_t = scalar(x_len)
        pos = scalar(x_pad + prefix_len)
        y_pos = scalar(prefix_len)
        gen_buf = torch.zeros((gen_max, B, K), dtype=ltype, device=dev)
        codebook_eog = torch.zeros((K,), dtype=torch.bool, device=dev)
        cur_num_gen = scalar(0)
        consec = torch.zeros((B,), dtype=ltype, device=dev)
        prev = torch.full((B,), -1, dtype=ltype, device=dev)
        keep = scalar(-1)
        alpha = model.alpha_audio.to(dtype)
        n = 0
        while True:
            samples, codebook_eog, consec, prev, keep = _batch_adjust_and_sample(
                cfg, scfg, cap_mult, generator, logits, codebook_eog,
                cur_num_gen, consec, prev, y_pos, x_len_t, keep)
            gen_buf[n] = samples
            emb = embed_audio_tokens(model.audio_emb, samples[:, :, None])
            pe = model.pe.index_select(0, y_pos.view(1)).to(dtype)
            x_t = (emb[:, 0].to(dtype) + alpha * pe)[:, None]       # [N,1,D]
            h, cache = trm.decode_step_fast(model.decoder, x_t, cache, pos,
                                            x_len=x_len_t, x_pad=x_pad)
            logits = apply_heads(model.heads, h[:, 0])
            pos += 1
            y_pos += 1
            cur_num_gen += 1
            n += 1
            if codebook_eog.all().item() or n >= gen_max:
                break
        return BatchResult(gen_buf, n, int(keep.clamp(min=0)), n)

    return decode
