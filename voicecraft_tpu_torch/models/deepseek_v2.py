"""DeepSeek-V2's decoder block in the port (ModelConfig.block
"deepseek_v2"): multi-head latent attention over a latent slab, RMSNorm,
YaRN rotary positions, a dense SwiGLU in the first
``first_k_dense_replace`` layers and routed plus shared SwiGLU experts in
the rest.  VoiceCraft's front end and heads (models/voicecraft.py) stay as
they are; this module is the stack between them.

The layer equations (h the layer's input; H heads, dn / dr the query-key
dims without and with rotary positions, dv the value dim, r the latent
rank):

    a = RMSNorm_1(h)
    q = a W_q                      -> [H, dn + dr]: q_nope, q_pe
    [c ; k_pe] = a W_kva           -> r + dr;  c <- RMSNorm_kv(c)
    [k_nope ; v] = c W_kvb         -> [H, dn + dv]
    q_pe, k_pe (one for all heads) rotated by pairs (2i, 2i + 1) at angle
        pos * f_i
    o = softmax(s [q_nope ; q_pe] . [k_nope ; k_pe]^T + causal and padding
        mask) v;  h += o W_o
    h += FFN(RMSNorm_2(h)): W_down(silu(x W_gate) * x W_up) in the dense
        layers, sum_{j in top k} p_j E_j(x) + E_shared(x) in the others,
        p = softmax(x W_router) in f32, not renormalised over the top k
    after the stack a final RMSNorm (every RMSNorm in f32, eps
    rms_norm_eps, with a gain).

YaRN (rope_scaling "yarn"): f_i = f_inter,i r_i + f_extra,i (1 - r_i),
f_extra,i = theta^(-2i / dr), f_inter,i = f_extra,i / factor, r_i =
clamp((i - lo) / (hi - lo), 0, 1), lo and hi the floor and the ceil of
dr ln(orig / (beta 2 pi)) / (2 ln theta) at beta_fast and beta_slow (10 and
23 for DeepSeek-V2-Lite).  cos and sin are scaled by mscale(factor,
mscale) / mscale(factor, mscale_all_dim) (1 where the two are equal),
mscale(f, m) = 0.1 m ln f + 1, and the softmax scale is
(dn + dr)^(-1/2) mscale(factor, mscale_all_dim)^2 (0.11472 for
DeepSeek-V2-Lite).  A token's rotary position is its index in its
unpadded [text ; audio] sequence: text token i at i, audio column j at
x_len + j, wherever the padded slab holds it.

The latent slab is [L, B, S_max, r + dr] in the compute dtype: the normed
c and the rotated k_pe of every position, written once by prefill and once
a step.  Prefill computes the attention unabsorbed (k_nope and v from c,
f32 logits and softmax).  A decode step absorbs W_kvb: the query over the
latent is q~ = [q_nope W_UK^T ; q_pe] (W_UK, W_UV the k_nope and v columns
of W_kvb), the slab is ONE kv head of r + dr keys and r values that all H
query heads read (ops.attention._attend_one), and the output is (p . c)
W_UV.  Scores and softmax stay in f32 (ops.attention.matmul_f32's rule).

The expert layers route on the device with no host sync (ops/moe.py), so a
decode step can be captured in a CUDA graph.  Spans (utils/tracing.py,
while a profiler records): ``mla.attend`` around each layer's latent
attention, ``moe.layer`` around each expert layer (router to combine, the
shared experts included), ``moe.experts`` around its routed grouped
products; and each decode forward's rows per expert
(``tracing.record_expert_rows``, [expert layers, experts]).

Not implemented, refused where asked for: training (``forward_train``),
fp8 weights and an fp8 slab, the fused FFN, speculative decoding (MTP
heads) and a mesh's 'model' split.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops import moe
from ..ops.attention import (NEG_INF, _attend_one, _ring_valid,
                             decode_attention_self, matmul_f32)
from ..utils import tracing

BLOCK = "deepseek_v2"


def _param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---- rotary positions and the softmax scale -----------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(cfg: ModelConfig) -> np.ndarray:
    """The rotary frequencies f_i [dr / 2] (float64; YaRN's blend of the
    interpolated and extrapolated frequencies, plain RoPE at factor 1)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = base ** (-np.arange(0, dim, 2, dtype=np.float64) / dim)
    if cfg.yarn_factor <= 1:
        return extra
    inter = extra / cfg.yarn_factor
    orig = cfg.yarn_original_max_position_embeddings

    def dim_at(beta):
        return dim * math.log(orig / (beta * 2 * math.pi)) / (2 * math.log(base))
    lo = max(math.floor(dim_at(cfg.yarn_beta_fast)), 0)
    hi = min(math.ceil(dim_at(cfg.yarn_beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - lo) / (hi - lo),
                   0.0, 1.0)
    return inter * ramp + extra * (1.0 - ramp)


def rope_tables(cfg: ModelConfig, n_pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [n_pos, dr / 2] (f32) of position p at f_i, times YaRN's
    cos/sin scale."""
    ang = np.arange(n_pos, dtype=np.float64)[:, None] * yarn_frequencies(cfg)
    m = (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
         / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    return (torch.from_numpy((np.cos(ang) * m).astype(np.float32)),
            torch.from_numpy((np.sin(ang) * m).astype(np.float32)))


def softmax_scale(cfg: ModelConfig) -> float:
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x [..., dr] with each pair (2i, 2i + 1) rotated by the angle whose
    cos / sin [..., dr / 2] are given, computed in f32, in x's dtype."""
    x1, x2 = x.float().unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).flatten(-2).to(x.dtype)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with gain g, computed in f32, in x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * g).to(x.dtype)


# ---- parameters ---------------------------------------------------------------------

class Layer(nn.Module):
    """One layer's parameters: the norms' gains (f32), the latent
    attention's W_q [D, H (dn + dr)], W_kva [D, r + dr], W_kvb [r, H (dn +
    dv)] and W_o [H dv, D], and a dense SwiGLU (``w1`` [D, 2 I], gate then
    up, and ``w2`` [I, D]) or the expert layer: the router [D, E], the
    routed experts (``experts_w1`` [E, D, 2 Ie], ``experts_w2`` [E, Ie,
    D]) and the shared experts as one SwiGLU of n_shared * Ie
    (``shared_w1``, ``shared_w2``).  No projection has a bias."""

    def __init__(self, cfg: ModelConfig, dense: bool, dtype: torch.dtype,
                 device):
        super().__init__()
        D, H, r = cfg.d_model, cfg.nhead, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        f32 = torch.float32
        self.dense = dense
        self.ln1_g = _param(D, dtype=f32, device=device)
        self.wq = _param(D, H * (dn + dr), dtype=dtype, device=device)
        self.wkv_a = _param(D, r + dr, dtype=dtype, device=device)
        self.kv_ln_g = _param(r, dtype=f32, device=device)
        self.wkv_b = _param(r, H * (dn + dv), dtype=dtype, device=device)
        self.wo = _param(H * dv, D, dtype=dtype, device=device)
        self.ln2_g = _param(D, dtype=f32, device=device)
        if dense:
            I = cfg.intermediate_size
            self.w1 = _param(D, 2 * I, dtype=dtype, device=device)
            self.w2 = _param(I, D, dtype=dtype, device=device)
        else:
            E, Ie = cfg.n_routed_experts, cfg.moe_intermediate_size
            Is = cfg.n_shared_experts * Ie
            self.router = _param(D, E, dtype=dtype, device=device)
            self.experts_w1 = _param(E, D, 2 * Ie, dtype=dtype, device=device)
            self.experts_w2 = _param(E, Ie, D, dtype=dtype, device=device)
            self.shared_w1 = _param(D, 2 * Is, dtype=dtype, device=device)
            self.shared_w2 = _param(Is, D, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Gains 1, every matrix uniform within its fan-in's bound."""
        for name, t in self.named_parameters():
            if name.endswith("_g"):
                t.fill_(1.0)
            else:
                bound = t.shape[-2] ** -0.5
                t.uniform_(-bound, bound, generator=generator)


class Decoder(nn.Module):
    """The stack: ``first_k_dense_replace`` dense layers, then expert
    layers, and the final RMSNorm's gain ``final_ln_g``.  Holds the rotary
    tables (buffers, not in the state) and the softmax scale."""

    block = BLOCK
    mesh = None

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device,
                 max_pos: int):
        super().__init__()
        self.cfg = cfg
        self.nhead = cfg.nhead
        self.scale = softmax_scale(cfg)
        self.layers = nn.ModuleList(
            Layer(cfg, li < cfg.first_k_dense_replace, dtype, device)
            for li in range(cfg.num_decoder_layers))
        self.final_ln_g = _param(cfg.d_model, dtype=torch.float32,
                                 device=device)
        # the engine's captured steps, for the last slab (StepGraphs)
        self.lane_graphs: dict = {}
        cos, sin = rope_tables(cfg, max_pos)
        self.register_buffer("rope_cos", cos.to(device), persistent=False)
        self.register_buffer("rope_sin", sin.to(device), persistent=False)

    @property
    def latent_dim(self) -> int:
        return self.cfg.kv_lora_rank + self.cfg.qk_rope_head_dim

    @property
    def n_expert_layers(self) -> int:
        return self.cfg.num_decoder_layers - self.cfg.first_k_dense_replace

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init_weights(generator)
        self.final_ln_g.fill_(1.0)


def init_latent_cache(num_layers: int, batch: int, s_max: int,
                      latent_dim: int, dtype: torch.dtype,
                      device) -> torch.Tensor:
    """The latent slab [L, B, S_max, r + dr]: each position's normed c
    and rotated k_pe."""
    return torch.zeros((num_layers, batch, s_max, latent_dim), dtype=dtype,
                       device=device)


# ---- the layer's parts ----------------------------------------------------------------

def _attn_inputs(dec: Decoder, layer: Layer, a: torch.Tensor,
                 pos: torch.Tensor):
    """(q_nope [B, T, H, dn], rotated q_pe [B, T, H, dr], the latent entry
    [c ; rotated k_pe] [B, T, r + dr]) of normed rows a [B, T, D] at rotary
    positions pos [B, T]."""
    cfg = dec.cfg
    B, T = a.shape[:2]
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q = (a @ layer.wq).view(B, T, dec.nhead, -1)
    kva = a @ layer.wkv_a
    cos, sin = dec.rope_cos[pos], dec.rope_sin[pos]                # [B,T,dr/2]
    c = rms_norm(kva[..., :r], layer.kv_ln_g, cfg.rms_norm_eps)
    k_pe = rotate(kva[..., r:], cos, sin)
    q_pe = rotate(q[..., dn:], cos[:, :, None], sin[:, :, None])
    return q[..., :dn], q_pe, torch.cat([c, k_pe], dim=-1)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
           ) -> torch.Tensor:
    """W_down(silu(x W_gate) * x W_up) with w1 = [W_gate | W_up]."""
    return moe.swiglu_hidden(x @ w1) @ w2


# ---- a layer's parts, each a function of tensors (a CUDA graph each when
# the engine's step replays them, StepGraphs) --------------------------------------

def _eager(name: Optional[str], fn: Callable, *args):
    """Run one part now, inside its span (none for ``name`` None)."""
    with tracing.span(name) if name else contextlib.nullcontext():
        return fn(*args)


def _dense_part(dec: Decoder, layer: Layer, x: torch.Tensor) -> torch.Tensor:
    return x + swiglu(rms_norm(x, layer.ln2_g, dec.cfg.rms_norm_eps),
                      layer.w1, layer.w2)


def _route_part(dec: Decoder, layer: Layer, x: torch.Tensor):
    """The expert layer's input rows, their routing and the routed rows
    ordered by expert: (rows [T, D], weights [T, k], order [T * k], rows
    per expert [E], offsets [E], routed rows [T * k, D])."""
    rows = rms_norm(x, layer.ln2_g, dec.cfg.rms_norm_eps).reshape(-1,
                                                                  x.shape[-1])
    k = dec.cfg.num_experts_per_tok
    weights, experts = moe.route(rows, layer.router, k)
    order, counts, offs = moe.group_by_expert(experts, dec.cfg.n_routed_experts)
    return rows, weights, order, counts, offs, rows.index_select(0, order // k)


def _experts_part(layer: Layer, xs: torch.Tensor, offs: torch.Tensor
                  ) -> torch.Tensor:
    return moe.expert_products(xs, offs, layer.experts_w1, layer.experts_w2)


def _combine_part(layer: Layer, x: torch.Tensor, rows: torch.Tensor,
                  weights: torch.Tensor, order: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """x plus the routed sum and the shared experts' output, added in f32
    and rounded once."""
    shared = swiglu(rows, layer.shared_w1, layer.shared_w2)
    return x + (moe.combine(y, order, weights) + shared.float()).to(
        x.dtype).view_as(x)


def _ffn(dec: Decoder, layer: Layer, x: torch.Tensor, run: Callable = _eager
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + the layer's FFN of RMSNorm_2(x), part by part through ``run``,
    and an expert layer's rows per expert [E] (None for a dense layer)."""
    if layer.dense:
        return run(None, _dense_part, dec, layer, x), None
    with tracing.span("moe.layer"):
        rows, weights, order, counts, offs, xs = run(None, _route_part, dec,
                                                     layer, x)
        y = run("moe.experts", _experts_part, layer, xs, offs)
        return run(None, _combine_part, layer, x, rows, weights, order,
                   y), counts


def _final_part(dec: Decoder, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, dec.final_ln_g, dec.cfg.rms_norm_eps)


# ---- prefill ----------------------------------------------------------------------------

def text_audio_positions(S: int, x_lens: torch.Tensor, x_pad: int
                         ) -> torch.Tensor:
    """Rotary positions [B, S] of a padded [x_pad text ; audio] sequence:
    column j < x_pad at j, audio column j at x_len + j - x_pad."""
    j = torch.arange(S, device=x_lens.device)[None, :]
    return torch.where(j < x_pad, j, x_lens.long()[:, None] + j - x_pad)


def prefill(dec: Decoder, x: torch.Tensor, x_lens: torch.Tensor,
            prefix_lens: torch.Tensor, x_pad: int, cache: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack over x [B, S, D] (a padded [text ; audio prefix]), keys
    valid in [0, x_len) u [x_pad, x_pad + prefix_len), causally, with the
    unabsorbed attention; fills cache[:, :, :S] in place.  Returns
    (final-normed hidden [B, S, D], cache)."""
    cfg = dec.cfg
    B, S, _ = x.shape
    H, dn = dec.nhead, cfg.qk_nope_head_dim
    pos = text_audio_positions(S, x_lens, x_pad)
    j = torch.arange(S, device=x.device)
    key_ok = ((j[None, :] < x_lens[:, None])
              | ((j[None, :] >= x_pad) & (j[None, :] < x_pad + prefix_lens[:, None])))
    allowed = ((j[None, :] <= j[:, None])[None] & key_ok[:, None, :])[:, None]
    for li, layer in enumerate(dec.layers):
        with tracing.span("mla.attend"):
            a = rms_norm(x, layer.ln1_g, cfg.rms_norm_eps)
            q_nope, q_pe, lat = _attn_inputs(dec, layer, a, pos)
            kv = (lat[..., :cfg.kv_lora_rank] @ layer.wkv_b).view(B, S, H, -1)
            k = torch.cat([kv[..., :dn],
                           lat[:, :, None, cfg.kv_lora_rank:].expand(
                               B, S, H, -1)], dim=-1)
            q = torch.cat([q_nope, q_pe], dim=-1)
            logits = matmul_f32(q.transpose(1, 2), k.permute(0, 2, 3, 1))
            logits = (logits * dec.scale).masked_fill(~allowed, NEG_INF)
            v = kv[..., dn:]
            probs = torch.softmax(logits, dim=-1).to(v.dtype)      # [B,H,S,S]
            o = matmul_f32(probs, v.transpose(1, 2)).to(v.dtype)
            x = x + o.transpose(1, 2).reshape(B, S, -1) @ layer.wo
        x = _ffn(dec, layer, x)[0]
        cache[li, :, :S] = lat.to(cache.dtype)
    return _final_part(dec, x), cache


# ---- decode ---------------------------------------------------------------------------

def _attn_part(dec: Decoder, layer: Layer, x: torch.Tensor,
               slab: torch.Tensor, pos: torch.Tensor, attend: Callable):
    """x plus the latent attention of one token a lane over the layer's
    slab [B, S_max, r + dr] (W_kvb absorbed), and the token's latent entry
    [B, 1, r + dr]."""
    cfg = dec.cfg
    B, H, r = x.shape[0], dec.nhead, cfg.kv_lora_rank
    dn = cfg.qk_nope_head_dim
    a = rms_norm(x, layer.ln1_g, cfg.rms_norm_eps)
    q_nope, q_pe, lat = _attn_inputs(dec, layer, a, pos[:, None])
    w_b = layer.wkv_b.view(r, H, -1)
    # q~ = q_nope W_UK^T per head: [H, B, dn] @ [H, dn, r]
    q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1),
                      w_b[..., :dn].permute(1, 2, 0)).transpose(0, 1)
    q_lat = torch.cat([q_lat, q_pe[:, 0]], dim=-1)              # [B,H,r+dr]
    slab, entry = slab.unsqueeze(2), lat.unsqueeze(2)   # [B,S,1,C], [B,1,1,C]
    o_lat = attend(q_lat.reshape(B, 1, -1), slab, slab[..., :r], entry,
                   entry[..., :r])                              # [B,1,H r]
    # (p . c) W_UV per head: [H, B, r] @ [H, r, dv]
    o = torch.bmm(o_lat.view(B, H, r).transpose(0, 1),
                  w_b[..., dn:].transpose(0, 1))
    return x + (o.transpose(0, 1).reshape(B, -1) @ layer.wo)[:, None], lat


def _decode_stack(dec: Decoder, x_t: torch.Tensor, cache: torch.Tensor,
                  pos: torch.Tensor, attend: Callable, run: Callable = _eager
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token a lane through the stack against the READ-ONLY latent
    slab, W_kvb absorbed: ``attend(q, k_slab, v_slab, k_new, v_new)`` is
    the step's masked attention over the slab read as one kv head (k:
    the whole latent [B, S_max, 1, r + dr], v: its c [B, S_max, 1, r]) plus
    the lane's own entry.  x_t [B, 1, D]; pos [B]: the rotary positions.
    ``run(span, part, *args)`` runs each part (eagerly, or a StepGraphs'
    capture or replay).  Returns (final-normed hidden [B, 1, D], the new
    latent entries [L, B, 1, r + dr]); the caller writes them once."""
    keep = tracing.recording()
    x, new, rows = x_t, [], []
    for li, layer in enumerate(dec.layers):
        x, lat = run("mla.attend", _attn_part, dec, layer, x, cache[li], pos,
                     attend)
        x, counts = _ffn(dec, layer, x, run)
        new.append(lat)
        if keep and counts is not None:
            rows.append(counts)
    if rows:
        tracing.record_expert_rows(torch.stack(rows))
    return run(None, _final_part, dec, x), torch.stack(new)


class StepGraphs:
    """The engine's decode step of the stack on one slab, each part (a
    layer's attention, its dense FFN or its expert layer's routing, routed
    products and combine; the final norm) captured into a CUDA graph of
    its own and replayed in order, each inside its span: a replayed
    graph's kernels carry the correlation id of its launch, which the span
    holds, so a trace ties them to the span as it ties an eager step's.
    The first step runs eagerly (settling what the captures reuse, as
    models/voicecraft.py:_CaptureSite does), the second captures every
    part and then replays them; the lane's token, its rotary position and
    the step's mask are copied into static buffers, and the slab is read
    and written in place.  The graphs share one memory pool, which holds
    as they are replayed in the order they were captured."""

    def __init__(self, x_t: torch.Tensor, pos: torch.Tensor,
                 valid: torch.Tensor):
        self.x, self.pos, self.valid = (x_t.clone(), pos.clone(),
                                        valid.clone())
        self.parts: list = []
        self.i = 0
        self.steps = 0
        self.pool = None

    def _capture(self, name, fn, *args):
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            out = fn(*args)
        finally:
            g.capture_end()
        self.pool = g.pool()
        self.parts.append((g, out))
        return out

    def _replay(self, name, fn, *args):
        g, out = self.parts[self.i]
        self.i += 1
        with tracing.span(name) if name else contextlib.nullcontext():
            g.replay()
        return out

    def step(self, dec: Decoder, x_t: torch.Tensor, cache: torch.Tensor,
             pos: torch.Tensor, valid: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        from .voicecraft import _CaptureSite
        self.x.copy_(x_t)
        self.pos.copy_(pos)
        self.valid.copy_(valid)
        attend = lambda q, ks, vs, kn, vn: _attend_one(
            q, ks, vs, self.valid, kn, vn, dec.scale)
        args = (dec, self.x, cache, self.pos, attend)
        self.steps += 1
        if self.steps <= 2:
            with _CaptureSite.of(x_t.device).running():
                if self.steps == 1:
                    return _decode_stack(*args)
                _decode_stack(*args, run=self._capture)
        self.i = 0
        return _decode_stack(*args, run=self._replay)


def decode_step(dec: Decoder, x_t: torch.Tensor, cache: torch.Tensor,
                pos: torch.Tensor, rope_pos: torch.Tensor,
                x_len: Optional[torch.Tensor] = None,
                x_pad: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One single-stream step (models.voicecraft.make_decode_loop): slab
    keys [0, pos) minus the text padding [x_len, x_pad), the new entry
    written at slot ``pos``.  pos / x_len: 0-d; rope_pos: the token's
    rotary position, 0-d or [B].  Returns (hidden [B, 1, D], cache)."""
    h, new = _decode_stack(
        dec, x_t, cache, rope_pos.reshape(-1).expand(x_t.shape[0]),
        lambda q, ks, vs, kn, vn: decode_attention_self(
            q, ks, vs, pos, kn, vn, dec.nhead, x_len, x_pad, dec.scale))
    cache.index_copy_(2, pos.view(1), new.to(cache.dtype))
    return h, cache


def lane_decode_step(dec: Decoder, x_t: torch.Tensor, cache: torch.Tensor,
                     x_lens, x_pad: int, prefix_lens, y_start: int, W: int,
                     gstep, t_lane) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the continuous-batching engine
    (inference/engine.py:_lane_decode_step) on the latent slab: the ring
    mask of ops.attention._ring_valid, lane b's token at rotary position
    x_len_b + prefix_len_b + t_b, every layer's entry written once at ring
    slot y_start + (gstep mod W).  On a CUDA card the stack's parts replay
    from CUDA graphs (:class:`StepGraphs`, kept on the decoder for the last
    slab it stepped)."""
    valid = _ring_valid(cache.shape[2], x_lens, x_pad, prefix_lens, y_start,
                        W, gstep, t_lane, x_t.device)
    pos = x_lens + prefix_lens + t_lane
    if x_t.device.type == "cuda":
        key = (cache.data_ptr(), tuple(cache.shape))
        graphs = dec.lane_graphs.get(key)
        if graphs is None:
            # one slab's graphs at a time: a new slab releases the last's
            dec.lane_graphs = {key: StepGraphs(x_t, pos, valid)}
            graphs = dec.lane_graphs[key]
        h, new = graphs.step(dec, x_t, cache, pos, valid)
    else:
        h, new = _decode_stack(
            dec, x_t, cache, pos,
            lambda q, ks, vs, kn, vn: _attend_one(q, ks, vs, valid, kn, vn,
                                                  dec.scale))
    cache.index_copy_(2, (y_start + torch.remainder(gstep, W)).view(1),
                      new.to(cache.dtype))
    return h, cache
