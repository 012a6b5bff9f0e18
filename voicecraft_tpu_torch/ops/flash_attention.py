"""Prefix attention for prefill: the CUDA kernel, its plain version, and the
one dispatcher that routes prefill attention; and training's differentiable
chunked attention (PyTorch port of voicecraft_tpu/ops/flash_attention.py).

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
from torch.utils.checkpoint import checkpoint

from . import _native
from .attention import NEG_INF, matmul_f32, mha, segment_padding_bias

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


# ---- training: differentiable chunked attention ---------------------------------

def _chunk_body(q_blk: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                valid: torch.Tensor, q0: int) -> torch.Tensor:
    """One query chunk [B, H, c, Dh] against every key: f32 logits under
    the mask k_pos <= q_pos & valid, f32 softmax, p@v with f32 sums, the
    output in q's dtype, [B, H, c, Dh]."""
    c, S = q_blk.shape[2], kh.shape[2]
    scale = 1.0 / math.sqrt(q_blk.shape[3])
    logits = matmul_f32(q_blk, kh.transpose(-1, -2)) * scale       # [B,H,c,S]
    q_pos = q0 + torch.arange(c, device=q_blk.device)
    k_pos = torch.arange(S, device=q_blk.device)
    mask = (k_pos[None, :] <= q_pos[:, None])[None, None] & valid[:, None, None]
    p = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
    return matmul_f32(p.to(vh.dtype), vh).to(q_blk.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      x_lens: torch.Tensor, y_lens: torch.Tensor, x_pad: int,
                      nhead: int, chunk: int = 256) -> torch.Tensor:
    """Training attention over [x_pad text ; audio] that keeps nothing of
    S x S for the backward: a loop over QUERY chunks of ``chunk`` rows (the
    last one holds the rest), each chunk's body under
    torch.utils.checkpoint, so the backward recomputes one chunk's
    [B, H, c, S] logits at a time and stores only q/k/v.  (The JAX package
    shrinks the chunk to a divisor of S, which its scan needs: 16 rows at
    the trainer's S = 400 + a multiple of 64.  Each row's result does not
    depend on the chunking.)  The mask is
    flash_prefix_attention's (causal, keys valid in [0, x_len) u [x_pad,
    x_pad + y_len)); no attention-prob dropout.  q/k/v: [B, S, D]; returns
    [B, S, D] in q's dtype.  On the card the products take bf16 operands
    with f32 sums (ops.attention.matmul_f32), the precision JAX's f32
    einsums get by default on the TPU; on the CPU everything is f32."""
    B, S, D = q.shape
    H = nhead
    Dh = D // H
    heads = lambda t: t.view(B, S, H, Dh).transpose(1, 2)          # [B,H,S,Dh]
    qh, kh, vh = heads(q), heads(k), heads(v)
    j = torch.arange(S, device=q.device)
    valid = ((j[None, :] < x_lens[:, None])
             | ((j[None, :] >= x_pad) & (j[None, :] < x_pad + y_lens[:, None])))
    outs = [checkpoint(_chunk_body, qh[:, :, i:i + chunk], kh, vh, valid, i,
                       use_reentrant=False)
            for i in range(0, S, chunk)]
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, D)
