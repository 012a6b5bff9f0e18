"""Prefix attention for prefill: the CUDA kernel, its plain version, and the
one dispatcher that routes prefill attention (PyTorch port of
voicecraft_tpu/ops/flash_attention.py).

``flash_prefix_attention`` takes the plain version for CPU tensors.  For
CUDA tensors it launches one kernel per dtype: bf16 (the card's path) the
tensor-core kernel of csrc/flash_prefix_attention_sm90.cu, f32 (the checks)
the simple kernel of csrc/flash_prefix_attention.cu.  There is no fallback
between any of them.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from . import _native
from .attention import NEG_INF, mha, segment_padding_bias

# Prefill length from which attention goes through the kernel (the JAX
# package's threshold, kept until the card's own crossover is measured).
FLASH_PREFILL_MIN_LEN = 1024

FLASH_HEAD_DIMS = (16, 32, 64, 128)


def flash_prefix_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, x_lens: torch.Tensor,
                                 y_lens: torch.Tensor, x_pad: int,
                                 nhead: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 logits of the scaled q
    against k, causal + two-segment key mask at NEG_INF, f32 softmax and
    p@v, output in q's dtype.  q/k/v: [B, S, D]; x_lens/y_lens: [B]."""
    B, S, D = q.shape
    Dh = D // nhead
    qh = q.float().view(B, S, nhead, Dh).transpose(1, 2) * (1.0 / math.sqrt(Dh))
    kh = k.float().view(B, S, nhead, Dh).transpose(1, 2)
    vh = v.float().view(B, S, nhead, Dh).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2))                  # [B,H,S,S]
    j = torch.arange(S, device=q.device)
    key_valid = ((j[None, :] < x_lens[:, None])
                 | ((j[None, :] >= x_pad) & (j[None, :] < x_pad + y_lens[:, None])))
    allowed = (j[None, :] <= j[:, None])[None] & key_valid[:, None, :]  # [B,S,S]
    logits = logits.masked_fill(~allowed[:, None], NEG_INF)
    out = torch.matmul(torch.softmax(logits, dim=-1), vh)
    return out.transpose(1, 2).reshape(B, S, D).to(q.dtype)


def flash_prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           x_lens: torch.Tensor, y_lens: torch.Tensor,
                           x_pad: int, nhead: int) -> torch.Tensor:
    """q/k/v: [B, S, D] (bf16 or f32); x_lens/y_lens: [B] int32 on q's
    device.  Returns [B, S, D] in q's dtype.  Causal over the joint
    sequence, keys valid in [0, x_len) u [x_pad, x_pad + y_len).  Rows of
    text padding (x_len <= q < x_pad) are not meaningful.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return flash_prefix_attention_plain(q, k, v, x_lens, y_lens, x_pad,
                                            nhead)
    name = "flash_prefix_attention"
    _native.require_cuda(name, q, k, v, x_lens, y_lens)
    B, S, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share one dtype of f32 or bf16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != q.shape or v.shape != q.shape or S < 1 or D % nhead:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, nhead {nhead}")
    Dh = D // nhead
    if Dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not in {FLASH_HEAD_DIMS}")
    if x_lens.dtype != torch.int32 or y_lens.dtype != torch.int32 or \
            x_lens.shape != (B,) or y_lens.shape != (B,):
        raise ValueError(f"{name}: x_lens/y_lens must be int32 [B]")
    out = torch.empty_like(q)
    err = _native.lib().vc_flash_prefix_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), x_lens.data_ptr(),
        y_lens.data_ptr(), out.data_ptr(), B, S, nhead, Dh, x_pad,
        1.0 / math.sqrt(Dh), _native.DTYPE_CODES[q.dtype], _native.stream(q))
    _native.check(err, name)
    _native.count_launch(name)
    return out


def prefill_attention(x_lens: torch.Tensor, y_lens: torch.Tensor, x_pad: int,
                      nhead: int, seq_len: int
                      ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                                    torch.Tensor]:
    """The one prefill-attention dispatcher: attn(q, k, v) for a
    [x_pad text ; audio] sequence of ``seq_len`` columns.  The kernel when
    the lengths live on CUDA and seq_len >= FLASH_PREFILL_MIN_LEN; dense
    ``mha`` under the segment bias otherwise."""
    if x_lens.device.type == "cuda" and seq_len >= FLASH_PREFILL_MIN_LEN:
        # q/k/v split from a packed qkv product are strided views; the
        # kernel reads contiguous tensors
        return lambda q, k, v: flash_prefix_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), x_lens, y_lens,
            x_pad, nhead)
    bias = segment_padding_bias(seq_len, x_pad, x_lens, y_lens)
    return lambda q, k, v: mha(q, k, v, bias, nhead)
