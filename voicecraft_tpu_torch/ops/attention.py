"""Attention ops for the decoder (PyTorch port of voicecraft_tpu/ops/attention.py).

Masks are computed from lengths, never materialised per head.  The rounding
points are the JAX package's: logits come out of their product in f32
(``matmul_f32``, the counterpart of ``preferred_element_type=f32``), the
scale and softmax are f32, probs are cast to v's dtype, and p@v sums in f32
before one rounding to v's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9  # large-negative instead of -inf: keeps softmax NaN-free for
                # fully-masked (padding) query rows


class _MatmulF32(torch.autograd.Function):
    """:func:`matmul_f32` with a backward, for training on the card: each
    gradient is the f32 product of the incoming gradient (rounded to the
    operands' dtype) against the other operand, summed over a broadcast
    batch and rounded once to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with torch.no_grad():
            return matmul_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = matmul_f32(g.to(a.dtype), b.mT).sum_to_size(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = matmul_f32(a.mT, g.to(b.dtype)).sum_to_size(b.shape).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as f32, the product never rounded to the operands' dtype.
    2-D, 3-D (one side may have a batch of 1) or 4-D [B, H, m, k].
    Differentiable: bf16 operands on CUDA that need a gradient go through
    ``_MatmulF32``.

    On CUDA, bf16 operands go to cuBLAS with an f32 output
    (``torch.bmm(..., out_dtype=f32)``), one call per product: a 4-D
    product at B > 1 flattens B and H into one batch, which copies an
    operand that is not a view of one (small q/k/v blocks, never a slab:
    products against a KV slab go through ``slab_scores`` / ``slab_pv``).
    On the CPU, where the port runs in f32, the operands are upcast."""
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        if a.dtype == torch.float32:
            return torch.matmul(a, b.float())
        return _MatmulF32.apply(a, b)
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    if a.dim() == 4:
        if a.shape[0] == 1 and b.shape[0] == 1:
            return matmul_f32(a[0], b[0])[None]
        B, H = a.shape[:2]
        out = torch.bmm(a.reshape(B * H, *a.shape[2:]),
                        b.reshape(B * H, *b.shape[2:]), out_dtype=torch.float32)
        return out.view(B, H, *out.shape[1:])
    n = max(a.shape[0], b.shape[0])
    return torch.bmm(a.expand(n, *a.shape[1:]), b.expand(n, *b.shape[1:]),
                     out_dtype=torch.float32)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.bmm as f32: on CUDA the operands' dtype in and f32 out (one
    cuBLAS call), on the CPU the operands upcast."""
    if a.device.type != "cuda":
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


def lane_slab_scores(qh: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """:func:`slab_scores` in the lanes' layout, ONE product batched over
    the lanes B that reads each lane's slab as the contiguous [S, H*Dh]
    matrix it is: the queries laid out block-diagonally, [B, H*Dh, H*T]
    with q[b, :, h] in block h, so that column block h of [S, H*Dh] @
    [H*Dh, H*T] is head h's logits.  H times the operations of the per-head
    products (still far under the slab's bytes at decode shapes), one call
    at any B, and no copy of the slab (``view`` raises rather than copy)."""
    B, H, T, Dh = qh.shape
    S = k_cache.shape[1]
    qbd = qh.new_zeros((B, H, Dh, H, T))
    qbd.diagonal(dim1=1, dim2=3).copy_(qh.permute(0, 3, 2, 1))
    out = _bmm_f32(k_cache.view(B, S, H * Dh), qbd.view(B, H * Dh, H * T))
    return out.view(B, S, H, T).permute(0, 2, 3, 1)               # [B,H,T,S]


def lane_slab_pv(probs: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """:func:`slab_pv` in the lanes' layout, the transpose of
    :func:`lane_slab_scores`': one product batched over the lanes, [H*T, S]
    @ [S, H*Dh], whose diagonal blocks (head h's rows against head h's
    columns) are the result."""
    B, H, T, S = probs.shape
    Dh = v_cache.shape[3]
    out = _bmm_f32(probs.reshape(B, H * T, S), v_cache.view(B, S, H * Dh))
    return out.view(B, H, T, H, Dh).diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)


def slab_scores(qh: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """f32 logits [B, H, T, S] of queries qh [B, H, T, Dh] against a KV
    slab k_cache [B, S, H, Dh] (unscaled), the slab read in place.

    On CUDA at B = 1 one product batched over the heads (each head's keys
    are a strided view).  At B > 1 the heads share no stride with the
    lanes, so :func:`lane_slab_scores` makes it one product batched over
    the lanes.  On the CPU, where the port runs in f32, a plain matmul."""
    if qh.device.type != "cuda":
        return torch.matmul(qh.float(), k_cache.float().permute(0, 2, 3, 1))
    if qh.shape[0] == 1:
        return matmul_f32(qh, k_cache.permute(0, 2, 3, 1))
    return lane_slab_scores(qh, k_cache)


def slab_pv(probs: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """f32 p@v [B, H, T, Dh] of probs [B, H, T, S] (the slab's columns, in
    v's dtype) against the slab v_cache [B, S, H, Dh], read in place; on
    CUDA at B > 1 through :func:`lane_slab_pv`."""
    if probs.device.type != "cuda":
        return torch.matmul(probs.float(), v_cache.float().permute(0, 2, 1, 3))
    if probs.shape[0] == 1:
        return matmul_f32(probs, v_cache.permute(0, 2, 1, 3))
    return lane_slab_pv(probs, v_cache)


def segment_padding_bias(s_total: int, x_max: int, x_lens: torch.Tensor,
                         y_lens: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Joint [x ; y] bias: causal + per-segment key padding.  Keys are valid
    when (j < x_len) or (x_max <= j < x_max + y_len).  Returns
    [B, 1, s_total, s_total]."""
    j = torch.arange(s_total, device=x_lens.device)
    key_valid = torch.where(j[None, :] < x_max,
                            j[None, :] < x_lens[:, None],
                            j[None, :] < x_max + y_lens[:, None])      # [B, S]
    causal = j[None, :] <= j[:, None]                                  # [S, S]
    allowed = causal[None] & key_valid[:, None, :]                     # [B, S, S]
    zero = torch.zeros((), dtype=dtype, device=x_lens.device)
    return torch.where(allowed, zero, NEG_INF).to(dtype)[:, None]


def dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Inverted dropout whose keep mask is drawn from a generator seeded
    with ``seed`` right here, so a checkpointed region that recomputes it
    draws the same mask (torch.utils.checkpoint restores the global RNGs,
    not a caller's generator).  No-op for rate 0 or seed None."""
    if rate <= 0.0 or seed is None:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
        nhead: int, dropout_rate: float = 0.0,
        seed: Optional[int] = None) -> torch.Tensor:
    """Dense multi-head attention.  q/k/v: [B, S, D] already projected;
    bias: [B or 1, 1, S_q, S_kv].  Returns [B, S_q, D] in v's dtype.
    Training's attention-prob dropout (``dropout_rate`` with a ``seed``)
    acts on the f32 probs."""
    B, Sq, D = q.shape
    Skv = k.shape[1]
    Dh = D // nhead
    qh = q.view(B, Sq, nhead, Dh).transpose(1, 2)
    kh = k.view(B, Skv, nhead, Dh).transpose(1, 2)
    vh = v.view(B, Skv, nhead, Dh).transpose(1, 2)
    logits = matmul_f32(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    probs = torch.softmax(logits + bias.float(), dim=-1)
    probs = dropout(probs, dropout_rate, seed).to(v.dtype)
    out = matmul_f32(probs, vh).to(v.dtype)
    return out.transpose(1, 2).reshape(B, Sq, D)


def _attend_one(q, k_cache, v_cache, valid, k_new, v_new,
                scale: Optional[float] = None):
    """One query per lane against the slab keys where ``valid`` (broadcast
    to [B, 1, 1, S_max]) plus its own k/v as an extra softmax term.

    The slab holds Hk key heads of Dk and value heads of Dv, [B, S_max, Hk,
    Dk] and [B, S_max, Hk, Dv]; q [B, 1, H * Dk] has H = Hk * G heads, G a
    kv head.  Multi-head attention has Hk = H (G = 1); a latent slab is ONE
    kv head that every query head reads (Hk = 1, G = H: the heads are the
    rows of one product against the slab), with Dk != Dv.  ``scale``: the
    softmax scale, 1 / sqrt(Dk) by default.  Returns [B, 1, H * Dv]."""
    B, S_max, Hk, Dk = k_cache.shape
    Dv = v_cache.shape[3]
    G = q.shape[-1] // (Hk * Dk)
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    qh = q.view(B, Hk, G, Dk)                  # [B,H,1,Dh] | latent [B,1,H,Dk]
    logits = slab_scores(qh, k_cache) * scale
    logits = logits.masked_fill(~valid, NEG_INF)                    # [B,Hk,G,S]
    logit_self = (qh.float() * k_new.transpose(1, 2).float()).sum(
        -1, keepdim=True) * scale                                   # [B,Hk,G,1]
    probs = torch.softmax(torch.cat([logits, logit_self], dim=-1),
                          dim=-1).to(v_cache.dtype)
    out = (slab_pv(probs[..., :-1], v_cache)
           + probs[..., -1:].float() * v_new.transpose(1, 2).float())
    return out.to(v_cache.dtype).reshape(B, 1, Hk * G * Dv)


def _attend_block(q, k_cache, v_cache, valid, k_new, v_new):
    """T queries per lane against the slab keys where ``valid`` (broadcast
    to [B, H, T, S_max]) plus the block itself, causally."""
    B, S_max, H, Dh = k_cache.shape
    T = k_new.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    qh = q.reshape(B, T, H, Dh).transpose(1, 2)                     # [B,H,T,Dh]
    logits = slab_scores(qh, k_cache) * scale                        # [B,H,T,S]
    logits = logits.masked_fill(~valid, NEG_INF)
    logit_blk = matmul_f32(qh, k_new.permute(0, 2, 3, 1)) * scale   # [B,H,T,T]
    t = torch.arange(T, device=q.device)
    logit_blk = logit_blk.masked_fill(t[None, :] > t[:, None], NEG_INF)
    probs = torch.softmax(torch.cat([logits, logit_blk], dim=-1),
                          dim=-1).to(v_cache.dtype)
    out = (slab_pv(probs[..., :S_max], v_cache)
           + matmul_f32(probs[..., S_max:], v_new.transpose(1, 2)))
    return out.to(v_cache.dtype).transpose(1, 2).reshape(B, T, H * Dh)


def _single_valid(S_max, kv_len, x_len, x_pad, device):
    """Slab keys [S_max] of one stream: [0, kv_len) minus the text padding
    [x_len, x_pad)."""
    j = torch.arange(S_max, device=device)
    valid = j < kv_len
    if x_pad is not None:
        valid = valid & ((j < x_len) | (j >= x_pad))
    return valid


def _lane_valid(S_max, x_lens, x_pad, prefix_lens, y_start, gen_end, device):
    """Slab keys [B, 1, 1, S_max] of B serving lanes: text [0, x_len_b),
    prompt [x_pad, x_pad + prefix_len_b) and generated [y_start,
    gen_end_b)."""
    j = torch.arange(S_max, device=device)[None, :]
    valid = ((j < x_lens[:, None])
             | ((j >= x_pad) & (j < x_pad + prefix_lens[:, None]))
             | ((j >= y_start) & (j < gen_end[:, None])))
    return valid[:, None, None, :]


def _ring_valid(S_max, x_lens, x_pad, prefix_lens, y_start, W, gstep, t_lane,
                device):
    """Slab keys [B, 1, 1, S_max] of B continuous-batching lanes: text and
    prompt as :func:`_lane_valid`, and the generated RING [y_start, y_start
    + W), written at slot g mod W on global step g: slot r was last written
    age(r) = 1 + ((gstep - 1 - r) mod W) steps ago and belongs to lane b's
    history iff age <= t_b (and the clock has run that far)."""
    j = torch.arange(S_max, device=device)[None, :]
    age = 1 + torch.remainder(gstep - 1 - (j - y_start), W)
    valid = ((j < x_lens[:, None])
             | ((j >= x_pad) & (j < x_pad + prefix_lens[:, None]))
             | ((j >= y_start) & (age <= t_lane[:, None]) & (gstep >= age)))
    return valid[:, None, None, :]


def decode_attention_ring(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, nhead: int,
                          x_lens: torch.Tensor, x_pad: int,
                          prefix_lens: torch.Tensor, y_start: int, W: int,
                          gstep, t_lane: torch.Tensor) -> torch.Tensor:
    """Decode attention of the continuous-batching engine: one query per
    lane over the read-only slab, whose generated region is a ring of W
    slots (:func:`_ring_valid`), plus the lane's own k/v.  The slab is read
    in place (``slab_scores`` / ``slab_pv``).  A lane reads only its own
    batch row, so lanes never mix.

    q: [B, 1, D]; k_cache/v_cache: [B, S_max, H, Dh]; k_new/v_new:
    [B, 1, H, Dh]; x_lens / prefix_lens / t_lane: [B]; gstep: the global
    steps completed before this one (0-d tensor or int).
    """
    valid = _ring_valid(k_cache.shape[1], x_lens, x_pad, prefix_lens, y_start,
                        W, gstep, t_lane, q.device)
    return _attend_one(q, k_cache, v_cache, valid, k_new, v_new)


def decode_attention_self(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          nhead: int, x_len: Optional[torch.Tensor] = None,
                          x_pad: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Single-step attention over a READ-ONLY slab plus the current token.

    The slab holds positions [0, kv_len) (minus text padding [x_len, x_pad));
    the current token's k/v enter the softmax as an extra term.  The slab
    keeps its native [B, S_max, H, Dh] layout and is read in place
    (``slab_scores`` / ``slab_pv``), never copied.

    q: [B, 1, D]; k_cache/v_cache: [B, S_max, H, Dh] in q's dtype; k_new /
    v_new: [B, 1, H, Dh]; kv_len / x_len: 0-d integer tensors.  A latent
    slab and ``scale``: :func:`_attend_one`.
    """
    valid = _single_valid(k_cache.shape[1], kv_len, x_len, x_pad, q.device)
    return _attend_one(q, k_cache, v_cache, valid, k_new, v_new, scale)


def decode_attention_self_block(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, kv_len: torch.Tensor,
                                k_new: torch.Tensor, v_new: torch.Tensor,
                                nhead: int, x_len: Optional[torch.Tensor] = None,
                                x_pad: Optional[int] = None) -> torch.Tensor:
    """The block form of :func:`decode_attention_self` for speculative
    decoding: T queries attend the read-only slab [0, kv_len) (minus text
    padding [x_len, x_pad)) plus the block itself, causally.  Slab entries
    at kv_len or beyond (a rejected draft's, from an earlier pass) are
    masked, which is what makes rewinding the write pointer sound.

    q: [B, T, D]; k_cache/v_cache: [B, S_max, H, Dh]; k_new/v_new:
    [B, T, H, Dh]; kv_len / x_len: 0-d integer tensors.
    """
    valid = _single_valid(k_cache.shape[1], kv_len, x_len, x_pad, q.device)
    return _attend_block(q, k_cache, v_cache, valid, k_new, v_new)


def decode_attention_multi(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_len: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor,
                           nhead: int, x_lens: torch.Tensor, x_pad: int,
                           prefix_lens: torch.Tensor, y_start: int
                           ) -> torch.Tensor:
    """Multi-stream decode attention (lockstep serving): per-lane segment
    validity.  Lane b's slab keys: text [0, x_len_b) within [0, x_pad),
    prompt [x_pad, x_pad + prefix_len_b) within [x_pad, y_start), generated
    [y_start, kv_len) (the write pointer is uniform over lanes).

    q: [B, 1, D]; k_cache/v_cache: [B, S_max, H, Dh]; k_new/v_new:
    [B, 1, H, Dh]; kv_len: 0-d; x_lens / prefix_lens: [B].
    """
    B, S_max = k_cache.shape[:2]
    valid = _lane_valid(S_max, x_lens, x_pad, prefix_lens, y_start,
                        kv_len.expand(B), q.device)
    return _attend_one(q, k_cache, v_cache, valid, k_new, v_new)


def decode_attention_multi_block(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, gen_lens: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 nhead: int, x_lens: torch.Tensor, x_pad: int,
                                 prefix_lens: torch.Tensor, y_start: int
                                 ) -> torch.Tensor:
    """Multi-stream BLOCK attention (speculative serving):
    :func:`decode_attention_multi`'s per-lane validity with the block's
    causal term, and a COMPACT generated region per lane, [y_start, y_start
    + gen_len_b): each lane writes its accepted tokens contiguously at its
    own offset, so a rejected draft's entries sit at y_start + gen_len_b or
    beyond and are never read (the rewind, per lane).

    q: [B, T, D]; k_cache/v_cache: [B, S_max, H, Dh]; k_new/v_new:
    [B, T, H, Dh]; gen_lens / x_lens / prefix_lens: [B].
    """
    valid = _lane_valid(k_cache.shape[1], x_lens, x_pad, prefix_lens, y_start,
                        y_start + gen_lens, q.device)
    return _attend_block(q, k_cache, v_cache, valid, k_new, v_new)
