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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as f32, the product never rounded to the operands' dtype.
    2-D, 3-D (one side may have a batch of 1) or 4-D [B, H, m, k].

    On CUDA, bf16 operands go to cuBLAS with an f32 output
    (``torch.bmm(..., out_dtype=f32)``); strided operands such as a KV slab
    are passed as views and never copied.  On the CPU, where the port runs
    in f32, the operands are upcast."""
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    if a.dim() == 4:
        if a.shape[0] == 1 and b.shape[0] == 1:
            return matmul_f32(a[0], b[0])[None]
        return torch.stack([matmul_f32(x, y) for x, y in zip(a, b)])
    n = max(a.shape[0], b.shape[0])
    return torch.bmm(a.expand(n, *a.shape[1:]), b.expand(n, *b.shape[1:]),
                     out_dtype=torch.float32)


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


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
        nhead: int) -> torch.Tensor:
    """Dense multi-head attention.  q/k/v: [B, S, D] already projected;
    bias: [B or 1, 1, S_q, S_kv].  Returns [B, S_q, D] in v's dtype."""
    B, Sq, D = q.shape
    Skv = k.shape[1]
    Dh = D // nhead
    qh = q.view(B, Sq, nhead, Dh).transpose(1, 2)
    kh = k.view(B, Skv, nhead, Dh).transpose(1, 2)
    vh = v.view(B, Skv, nhead, Dh).transpose(1, 2)
    logits = matmul_f32(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    probs = torch.softmax(logits + bias.float(), dim=-1).to(v.dtype)
    out = matmul_f32(probs, vh).to(v.dtype)
    return out.transpose(1, 2).reshape(B, Sq, D)


def decode_attention_self(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          nhead: int, x_len: Optional[torch.Tensor] = None,
                          x_pad: Optional[int] = None) -> torch.Tensor:
    """Single-step attention over a READ-ONLY slab plus the current token.

    The slab holds positions [0, kv_len) (minus text padding [x_len, x_pad));
    the current token's k/v enter the softmax as an extra term.  The slab
    keeps its native [B, S_max, H, Dh] layout: the products read it through
    strided views, with no transposed copy.

    q: [B, 1, D]; k_cache/v_cache: [B, S_max, H, Dh]; k_new/v_new:
    [B, 1, H, Dh]; kv_len / x_len: 0-d integer tensors.
    """
    B, S_max, H, Dh = k_cache.shape
    scale = 1.0 / math.sqrt(Dh)
    qh = q.view(B, 1, H, Dh).transpose(1, 2)                        # [B,H,1,Dh]
    logits = matmul_f32(qh, k_cache.permute(0, 2, 3, 1)) * scale
    j = torch.arange(S_max, device=q.device)
    mask = j < kv_len
    if x_pad is not None:
        mask = mask & ((j < x_len) | (j >= x_pad))
    logits = logits.masked_fill(~mask, NEG_INF)                      # [B,H,1,S]
    logit_self = (qh.float() * k_new.transpose(1, 2).float()).sum(
        -1, keepdim=True) * scale                                    # [B,H,1,1]
    probs = torch.softmax(torch.cat([logits, logit_self], dim=-1),
                          dim=-1).to(v_cache.dtype)
    out = (matmul_f32(probs[..., :-1], v_cache.permute(0, 2, 1, 3))
           + probs[..., -1:].float() * v_new.transpose(1, 2).float())
    return out.to(v_cache.dtype).transpose(1, 2).reshape(B, 1, H * Dh)


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
    B, S_max, H, Dh = k_cache.shape
    T = k_new.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    qh = q.reshape(B, T, H, Dh).transpose(1, 2)                     # [B,H,T,Dh]
    logits = matmul_f32(qh, k_cache.permute(0, 2, 3, 1)) * scale    # [B,H,T,S]
    j = torch.arange(S_max, device=q.device)
    mask = j < kv_len
    if x_pad is not None:
        mask = mask & ((j < x_len) | (j >= x_pad))
    logits = logits.masked_fill(~mask, NEG_INF)
    logit_blk = matmul_f32(qh, k_new.permute(0, 2, 3, 1)) * scale   # [B,H,T,T]
    t = torch.arange(T, device=q.device)
    logit_blk = logit_blk.masked_fill(t[None, :] > t[:, None], NEG_INF)
    probs = torch.softmax(torch.cat([logits, logit_blk], dim=-1),
                          dim=-1).to(v_cache.dtype)
    out = (matmul_f32(probs[..., :S_max], v_cache.permute(0, 2, 1, 3))
           + matmul_f32(probs[..., S_max:], v_new.transpose(1, 2)))
    return out.to(v_cache.dtype).transpose(1, 2).reshape(B, T, H * Dh)
