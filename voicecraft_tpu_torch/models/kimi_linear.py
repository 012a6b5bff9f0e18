"""Kimi Linear's decoder block in the port (ModelConfig.block
"kimi_linear"): Kimi Delta Attention (KDA) layers beside latent attention
layers without rotary positions, a dense SwiGLU in the first
``first_k_dense_replace`` layers and routed plus shared SwiGLU experts in
the rest.  VoiceCraft's front end and heads (models/voicecraft.py) stay as
they are; this module is the stack between them.  The latent attention and
the expert layers are DeepSeek-V2's (models/deepseek_v2.py), with its
rotation off (``mla_use_nope``) and the router the configuration gives
(ops/moe.py).

A KDA layer (h the layer's input, H heads of dk = dv dims):

    a = RMSNorm_1(h)
    q, k, v = SiLU(ShortConv_W(a W_q)), ...(a W_k), ...(a W_v): causal
        depthwise convolutions of width W (kda_conv_size), no bias
    q, k L2-normalised per head (x / sqrt(sum x^2 + 1e-6))
    g = -exp(A_log[h]) softplus(a W_fa W_fb + dt_bias)      per channel
    beta = sigmoid(a W_b)                                   per head
    per head: S <- S exp(g)[:, None];  u = beta (v - S^T k);  S <- S + k u^T;
        o = S^T q dk^-1/2                                  (ops/kda.py)
    h += (RMSNorm_head(o) * sigmoid(a W_ga W_gb + b_gb)) W_o

then, in every layer, h += FFN(RMSNorm_2(h)), and after the stack a final
RMSNorm.  Products round to the compute dtype; the convolution, the
norms, the gates, the decay and beta are computed in f32 and rounded once;
q, k and v enter the recurrence in the compute dtype, g and beta in f32,
and the state and o are f32.

The cache (:class:`HybridCache`) holds three parts a lane: the latent slab
of the latent-attention layers [L_mla, B, S_max, r + dr] (the compute
dtype, DeepSeek-V2's layout), the KDA state [L_kda, B, H, dk, dv] (f32,
whatever the slab's dtype) and the convolutions' state [L_kda, B, W - 1,
3 H dk]: each lane's last W - 1 projections before the convolution.

Prefill runs the stack over each lane's real tokens packed ([text ;
audio] without the text padding, positions 0 .. len - 1, the padded tail
after them): the recurrence and the convolution see only real tokens, the
latent attention is causal over them, and the latent entries and the
hidden are laid back into the padded layout the decode steps read.  A
decode step advances every lane by one token: the convolution from the
lane's state, the recurrence through the kernel (one launch a KDA layer),
the latent attention over the slab as DeepSeek-V2's step.

Spans (utils/tracing.py, while a profiler records): ``kda.attend`` around
each KDA layer's whole attention (prefill and decode), ``kda.recur``
around a decode step's recurrence (its kernel only), ``kda.prefill``
around a prefill's recurrence; DeepSeek-V2's ``mla.attend``, ``moe.layer``
and ``moe.experts``; each decode forward's rows per held expert
(``tracing.record_expert_rows``) and each decode recurrence's lanes
(``tracing.record_kda_call``).

Not implemented, refused where asked for: training, fp8 weights and an
fp8 slab, the fused FFN, speculative decoding (MTP heads) and a mesh's
'model' split.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops import kda
from ..ops.attention import _attend_one, _ring_valid, decode_attention_self
from ..utils import tracing
from . import deepseek_v2 as dsv2
from .deepseek_v2 import _param, rms_norm

BLOCK = "kimi_linear"

L2_EPS = 1e-6


# ---- parameters ---------------------------------------------------------------------

class KDALayer(nn.Module):
    """One KDA layer's parameters: ``ln1_g`` (f32), W_q | W_k | W_v as one
    ``w_qkv`` [D, 3 H dk], the convolutions' ``conv_w`` [3 H dk, W] (tap
    W - 1 multiplies the current token), the decay's ``w_fa`` [D, dk],
    ``w_fb`` [dk, H dk], ``dt_bias`` [H dk] and ``A_log`` [H] (f32), beta's
    ``w_b`` [D, H], the output gate's ``w_ga`` [D, dk], ``w_gb`` [dk, H
    dk] and ``b_gb`` [H dk] (f32), the head norm's gain ``o_norm_g`` [dk]
    (f32) and ``wo`` [H dk, D]; then the FFN's (deepseek_v2.ffn_params)."""

    def __init__(self, cfg: ModelConfig, dense: bool, dtype: torch.dtype,
                 device):
        super().__init__()
        D, H, dk = cfg.d_model, cfg.kda_num_heads, cfg.kda_head_dim
        HK, f32 = H * dk, torch.float32
        self.ln1_g = _param(D, dtype=f32, device=device)
        self.w_qkv = _param(D, 3 * HK, dtype=dtype, device=device)
        self.conv_w = _param(3 * HK, cfg.kda_conv_size, dtype=dtype,
                             device=device)
        self.w_fa = _param(D, dk, dtype=dtype, device=device)
        self.w_fb = _param(dk, HK, dtype=dtype, device=device)
        self.dt_bias = _param(HK, dtype=f32, device=device)
        self.A_log = _param(H, dtype=f32, device=device)
        self.w_b = _param(D, H, dtype=dtype, device=device)
        self.w_ga = _param(D, dk, dtype=dtype, device=device)
        self.w_gb = _param(dk, HK, dtype=dtype, device=device)
        self.b_gb = _param(HK, dtype=f32, device=device)
        self.o_norm_g = _param(dk, dtype=f32, device=device)
        self.wo = _param(HK, D, dtype=dtype, device=device)
        dsv2.ffn_params(self, cfg, dense, dtype, device)


class Decoder(nn.Module):
    """The stack: KDA layers where ``kda_layers`` (1-indexed) says, latent
    attention (deepseek_v2.Layer) in the others, dense FFNs in the first
    ``first_k_dense_replace`` layers and expert layers after them, and the
    final RMSNorm's gain ``final_ln_g``.  ``slot[li]``: layer li's index in
    the KDA state (a KDA layer) or in the latent slab."""

    block = BLOCK
    mesh = None

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        self.nhead = cfg.nhead
        self.scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
        kda_layers = set(cfg.kda_layers)
        self.is_kda = [li + 1 in kda_layers
                       for li in range(cfg.num_decoder_layers)]
        self.layers = nn.ModuleList(
            (KDALayer if is_kda else dsv2.Layer)(
                cfg, li < cfg.first_k_dense_replace, dtype, device)
            for li, is_kda in enumerate(self.is_kda))
        self.final_ln_g = _param(cfg.d_model, dtype=torch.float32,
                                 device=device)
        self.slot = [sum(1 for b in self.is_kda[:li] if b == is_kda)
                     for li, is_kda in enumerate(self.is_kda)]

    @property
    def latent_dim(self) -> int:
        return self.cfg.kv_lora_rank + self.cfg.qk_rope_head_dim

    @property
    def n_kda_layers(self) -> int:
        return sum(self.is_kda)

    @property
    def n_latent_layers(self) -> int:
        return len(self.is_kda) - self.n_kda_layers

    @property
    def n_expert_layers(self) -> int:
        return self.cfg.num_decoder_layers - self.cfg.first_k_dense_replace

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Gains 1; ``A_log`` = ln U(1, 16); ``dt_bias`` the inverse
        softplus of dt = exp U(ln 1e-3, ln 0.1) (Mamba's); the correction
        bias U(-0.01, 0.01); ``b_gb`` 0; the convolutions within 1 /
        sqrt(W); every matrix uniform within its fan-in's bound."""
        for name, t in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_g"):
                t.fill_(1.0)
            elif leaf == "A_log":
                t.uniform_(1.0, 16.0, generator=generator).log_()
            elif leaf == "dt_bias":
                dt = torch.empty_like(t).uniform_(
                    math.log(1e-3), math.log(0.1), generator=generator).exp_()
                t.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif leaf == "router_bias":
                t.uniform_(-0.01, 0.01, generator=generator)
            elif leaf == "b_gb":
                t.zero_()
            else:
                bound = (t.shape[-1] if leaf == "conv_w"
                         else t.shape[-2]) ** -0.5
                t.uniform_(-bound, bound, generator=generator)


class HybridCache:
    """The block's cache, three parts a lane: ``slab`` [L_mla, B, S_max,
    r + dr] (the latent slab), ``state`` [L_kda, B, H, dk, dv] (f32, the
    KDA state) and ``conv`` [L_kda, B, W - 1, 3 H dk] (the convolutions'
    last inputs).  Every lane starts at zero."""

    def __init__(self, dec: Decoder, batch: int, s_max: int,
                 dtype: torch.dtype, device):
        cfg = dec.cfg
        H, dk = cfg.kda_num_heads, cfg.kda_head_dim
        L = dec.n_kda_layers
        self.slab = torch.zeros((dec.n_latent_layers, batch, s_max,
                                 dec.latent_dim), dtype=dtype, device=device)
        self.state = torch.zeros((L, batch, H, dk, dk), dtype=torch.float32,
                                 device=device)
        self.conv = torch.zeros((L, batch, cfg.kda_conv_size - 1, 3 * H * dk),
                                dtype=dtype, device=device)

    @property
    def slots(self) -> int:
        return self.slab.shape[2]

    def store_lanes(self, idx: torch.Tensor, new: "HybridCache") -> None:
        """Write lanes ``idx`` [n] from ``new`` (a prefill's cache of n
        lanes): its slab slots over the first ones, its states whole."""
        self.slab[:, idx, :new.slots] = new.slab
        self.state[:, idx] = new.state
        self.conv[:, idx] = new.conv


# ---- the KDA layer's arithmetic ----------------------------------------------------

def _l2_normed(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().sum(-1, keepdim=True) + L2_EPS)
            ).to(x.dtype)


def _conv_silu(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of width W over xs [B, T +
    W - 1, C] (the W - 1 inputs before the first output's token, then its
    T tokens) with taps w [C, W], in f32, rounded once: [B, T, C]."""
    W = w.shape[1]
    T = xs.shape[1] - W + 1
    acc = xs[:, :T].float() * w[:, 0].float()
    for j in range(1, W):
        acc = acc + xs[:, j:j + T].float() * w[:, j].float()
    return F.silu(acc).to(xs.dtype)


def _kda_inputs(dec: Decoder, layer: KDALayer, a: torch.Tensor,
                c: torch.Tensor):
    """(q, k, v [B, T, H, dk] in the compute dtype, g [B, T, H, dk] f32,
    beta [B, T, H] f32) from normed rows a [B, T, D] and the convolved
    q | k | v c [B, T, 3 H dk]."""
    cfg = dec.cfg
    B, T = a.shape[:2]
    H, dk = cfg.kda_num_heads, cfg.kda_head_dim
    q, k, v = (t.reshape(B, T, H, dk) for t in c.chunk(3, dim=-1))
    f = (a @ layer.w_fa) @ layer.w_fb
    g = (-layer.A_log.exp()[:, None]
         * F.softplus(f.float() + layer.dt_bias).view(B, T, H, dk))
    beta = torch.sigmoid((a @ layer.w_b).float())
    return _l2_normed(q), _l2_normed(k), v.contiguous(), g, beta


def _kda_output(dec: Decoder, layer: KDALayer, x: torch.Tensor,
                a: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """x plus the gated, head-normed recurrence output o [B, T, H, dv]
    (f32) through W_o."""
    B, T = x.shape[:2]
    on = o * torch.rsqrt(o.square().mean(-1, keepdim=True)
                         + dec.cfg.rms_norm_eps) * layer.o_norm_g
    gate = torch.sigmoid(((a @ layer.w_ga) @ layer.w_gb).float()
                         + layer.b_gb).view_as(on)
    return x + (on * gate).to(x.dtype).reshape(B, T, -1) @ layer.wo


# ---- prefill ----------------------------------------------------------------------------

def _kda_prefill(dec: Decoder, layer: KDALayer, x: torch.Tensor,
                 lens: torch.Tensor, state: torch.Tensor, conv: torch.Tensor
                 ) -> torch.Tensor:
    """x [B, T, D] (lanes packed, lane b's first lens[b] rows real) plus
    the layer's KDA; writes the lanes' KDA state and their convolution
    state (the last W - 1 projections of their real tokens) in place."""
    cfg = dec.cfg
    W = cfg.kda_conv_size
    with tracing.span("kda.attend"):
        a = rms_norm(x, layer.ln1_g, cfg.rms_norm_eps)
        xs = F.pad(a @ layer.w_qkv, (0, 0, W - 1, 0))       # [B, W-1+T, C]
        last = (lens[:, None] + torch.arange(W - 1, device=x.device))
        conv.copy_(xs.gather(1, last[..., None].expand(-1, -1, xs.shape[2])))
        q, k, v, g, beta = _kda_inputs(dec, layer, a,
                                       _conv_silu(xs, layer.conv_w))
        with tracing.span("kda.prefill"):
            o = kda.kda_recurrent(q, k, v, g, beta, state, lens)
        return _kda_output(dec, layer, x, a, o)


def prefill(dec: Decoder, x: torch.Tensor, x_lens: torch.Tensor,
            prefix_lens: torch.Tensor, x_pad: int, cache: HybridCache
            ) -> Tuple[torch.Tensor, HybridCache]:
    """The stack over x [B, S, D] (a padded [text ; audio prefix]: text in
    [0, x_len), audio in [x_pad, x_pad + prefix_len)), each lane's real
    tokens packed; fills the cache's KDA and convolution states and its
    slab's slots [0, S) (the padded layout) in place.  Returns
    (final-normed hidden [B, S, D] in the padded layout, cache)."""
    B, S, D = x.shape
    dev = x.device
    xl = x_lens.long()[:, None]
    lens = (x_lens + prefix_lens).long()
    p = torch.arange(S, device=dev)[None, :]
    # packed position p <- padded column; padded column <- packed position
    src = torch.where(p < xl, p, x_pad + p - xl).clamp(max=S - 1)
    back = torch.where(p < xl, p, torch.where(p >= x_pad, xl + p - x_pad, 0)
                       ).clamp(max=S - 1)
    rows = lambda t, idx: t.gather(1, idx[..., None].expand(-1, -1,
                                                            t.shape[2]))
    h = rows(x, src)
    allowed = ((p <= p.T)[None] & (p < lens[:, None])[:, None, :])[:, None]
    for li, layer in enumerate(dec.layers):
        i = dec.slot[li]
        if dec.is_kda[li]:
            h = _kda_prefill(dec, layer, h, lens, cache.state[i],
                             cache.conv[i])
        else:
            h, lat = dsv2.prefill_attention(dec, layer, h, None, allowed)
            cache.slab[i, :, :S] = rows(lat, back).to(cache.slab.dtype)
        h = dsv2._ffn(dec, layer, h)[0]
    return rows(dsv2._final_part(dec, h), back), cache


# ---- decode -----------------------------------------------------------------------------

def _kda_in_part(dec: Decoder, layer: KDALayer, x: torch.Tensor,
                 conv: torch.Tensor):
    """One token a lane x [B, 1, D]: (normed rows a, q, k, v, g, beta) of
    the layer's KDA, the convolution over the lanes' state conv [B, W - 1,
    C], which it advances in place."""
    a = rms_norm(x, layer.ln1_g, dec.cfg.rms_norm_eps)
    window = torch.cat([conv, a @ layer.w_qkv], dim=1)              # [B,W,C]
    conv.copy_(window[:, 1:])
    return (a,) + _kda_inputs(dec, layer, a,
                              _conv_silu(window, layer.conv_w))


def _decode_stack(dec: Decoder, x_t: torch.Tensor, cache: HybridCache,
                  attend: Callable, run: Callable = dsv2._eager
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token a lane through the stack: the KDA layers advance the
    cache's KDA and convolution states in place, the latent-attention
    layers read the slab read-only (``attend``: deepseek_v2._decode_stack's).
    ``run(span, part, *args)`` runs each part (eagerly, or
    deepseek_v2.StepGraphs.run).  Returns (final-normed hidden [B, 1, D],
    the latent layers' new entries [L_mla, B, 1, r + dr]); the caller
    writes them once."""
    keep = tracing.recording()
    x, new, rows = x_t, [], []
    for li, layer in enumerate(dec.layers):
        i = dec.slot[li]
        if dec.is_kda[li]:
            with tracing.span("kda.attend"):
                a, q, k, v, g, beta = run(None, _kda_in_part, dec, layer, x,
                                          cache.conv[i])
                o = run("kda.recur", kda.kda_recurrent, q, k, v, g, beta,
                        cache.state[i])
                x = run(None, _kda_output, dec, layer, x, a, o)
            if keep:
                tracing.record_kda_call(x.shape[0])
        else:
            x, lat = run("mla.attend", dsv2._attn_part, dec, layer, x,
                         cache.slab[i], None, attend)
            new.append(lat)
        x, counts = dsv2._ffn(dec, layer, x, run)
        if keep and counts is not None:
            rows.append(counts)
    if rows:
        tracing.record_expert_rows(torch.stack(rows))
    return run(None, dsv2._final_part, dec, x), torch.stack(new)


def decode_step(dec: Decoder, x_t: torch.Tensor, cache: HybridCache,
                pos: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                x_pad: Optional[int] = None
                ) -> Tuple[torch.Tensor, HybridCache]:
    """One single-stream step (models.voicecraft.make_decode_loop): slab
    keys [0, pos) minus the text padding [x_len, x_pad), the new entries
    written at slot ``pos`` (0-d).  Returns (hidden [B, 1, D], cache)."""
    h, new = _decode_stack(
        dec, x_t, cache,
        lambda q, ks, vs, kn, vn: decode_attention_self(
            q, ks, vs, pos, kn, vn, dec.nhead, x_len, x_pad, dec.scale))
    cache.slab.index_copy_(2, pos.view(1), new.to(cache.slab.dtype))
    return h, cache


def lane_decode_step(dec: Decoder, x_t: torch.Tensor, cache: HybridCache,
                     x_lens, x_pad: int, prefix_lens, y_start: int, W: int,
                     gstep, t_lane, parts: Optional[dsv2.StepGraphs] = None
                     ) -> Tuple[torch.Tensor, HybridCache]:
    """One step of the continuous-batching engine (inference/engine.py:
    _lane_decode_step): the latent layers under the ring mask of
    ops.attention._ring_valid, their entries written once at ring slot
    y_start + (gstep mod W); every lane's KDA state advanced by its token.
    The stack's parts run through ``parts`` (the engine's, where its steps
    are graphed), else eagerly."""
    valid = _ring_valid(cache.slots, x_lens, x_pad, prefix_lens, y_start, W,
                        gstep, t_lane, x_t.device)
    # reads ``valid`` when called: the static copy where the parts replay
    attend = lambda q, ks, vs, kn, vn: _attend_one(q, ks, vs, valid, kn, vn,
                                                   dec.scale)
    if parts is None:
        h, new = _decode_stack(dec, x_t, cache, attend)
    else:
        x_t, valid = parts.bind(x_t, valid)
        h, new = _decode_stack(dec, x_t, cache, attend, parts.run)
    cache.slab.index_copy_(2, (y_start + torch.remainder(gstep, W)).view(1),
                           new.to(cache.slab.dtype))
    return h, cache
