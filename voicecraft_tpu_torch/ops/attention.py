"""Attention ops for the decoder (PyTorch port of voicecraft_tpu/ops/attention.py).

Masks are computed from lengths, never materialised per head.  Logits and
softmax are f32; products run in the activations' dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9  # large-negative instead of -inf: keeps softmax NaN-free for
                # fully-masked (padding) query rows


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
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() * (1.0 / math.sqrt(Dh))
    probs = torch.softmax(logits + bias.float(), dim=-1).to(v.dtype)
    out = torch.matmul(probs, vh)
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
    logits = torch.matmul(qh, k_cache.permute(0, 2, 3, 1)).float() * scale
    j = torch.arange(S_max, device=q.device)
    mask = j < kv_len
    if x_pad is not None:
        mask = mask & ((j < x_len) | (j >= x_pad))
    logits = logits.masked_fill(~mask, NEG_INF)                      # [B,H,1,S]
    logit_self = (qh.float() * k_new.transpose(1, 2).float()).sum(
        -1, keepdim=True) * scale                                    # [B,H,1,1]
    probs = torch.softmax(torch.cat([logits, logit_self], dim=-1),
                          dim=-1).to(v_cache.dtype)
    out = (torch.matmul(probs[..., :-1], v_cache.permute(0, 2, 1, 3)).float()
           + probs[..., -1:].float() * v_new.transpose(1, 2).float())
    return out.to(v_cache.dtype).transpose(1, 2).reshape(B, 1, H * Dh)
