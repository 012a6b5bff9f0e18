"""Decode attention of the continuous-batching engine over an fp8 KV slab:
the CUDA kernel of csrc/ring_decode_attention.cu, which reads the slab in
place, and its plain version.

The plain version is the engine's arithmetic before the kernel: the
layer's slab upcast to q's dtype, then :func:`ops.attention.
decode_attention_ring` (the ring mask of ``_ring_valid`` and
``_attend_one``).  The kernel keeps its rounding points and reads each
allowed key's fp8 bytes once, with no upcast copy.

``ring_decode_attention`` takes the plain version for CPU tensors; for
CUDA tensors it launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import math

import torch

from . import _native
from .attention import decode_attention_ring

RING_HEAD_DIMS = (16, 32, 64, 128)


def ring_decode_attention_plain(q: torch.Tensor, k_slab: torch.Tensor,
                                v_slab: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, x_lens: torch.Tensor,
                                x_pad: int, prefix_lens: torch.Tensor,
                                y_start: int, W: int, gstep,
                                t_lane: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the slab upcast to q's
    dtype (exact from fp8), then the ring attention of
    ops.attention.decode_attention_ring."""
    return decode_attention_ring(q, k_slab.to(q.dtype), v_slab.to(q.dtype),
                                 k_new, v_new, k_slab.shape[2], x_lens, x_pad,
                                 prefix_lens, y_start, W, gstep, t_lane)


def _lane_stride(name: str, t: torch.Tensor) -> int:
    """The stride between the lanes of q / k_new / v_new [B, 1, ...], whose
    rows must each be contiguous and 16-byte aligned (the views of a packed
    qkv product are)."""
    if not t[0, 0].is_contiguous():
        raise ValueError(f"{name}: each lane's row must be contiguous, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    stride = t.stride(0)
    if t.data_ptr() % 16 or (stride * t.element_size()) % 16:
        raise ValueError(f"{name}: lanes must start 16-byte aligned")
    return stride


def ring_decode_attention(q: torch.Tensor, k_slab: torch.Tensor,
                          v_slab: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, x_lens: torch.Tensor,
                          x_pad: int, prefix_lens: torch.Tensor, y_start: int,
                          W: int, gstep: torch.Tensor,
                          t_lane: torch.Tensor) -> torch.Tensor:
    """One query per lane over the ring slab (ops.attention.
    decode_attention_ring) with the slab read in place.

    q: [B, 1, H*Dh] (bf16 or f32); k_slab / v_slab: one layer's fp8 e4m3
    slab views [B, S_max, H, Dh]; k_new / v_new: [B, 1, H, Dh] in q's dtype;
    x_lens / prefix_lens / t_lane: [B] int64 and gstep a 0-d int64 tensor,
    on the slab's device; Dh in RING_HEAD_DIMS, any H.  Returns [B, 1,
    H*Dh] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return ring_decode_attention_plain(q, k_slab, v_slab, k_new, v_new,
                                           x_lens, x_pad, prefix_lens,
                                           y_start, W, gstep, t_lane)
    name = "ring_decode_attention"
    _native.require_cuda(name, k_slab, v_slab, x_lens, prefix_lens, t_lane,
                         gstep)
    for t in (q, k_new, v_new):
        if t.device != k_slab.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{k_slab.device}")
    B, S, H, Dh = k_slab.shape
    if k_slab.dtype != torch.float8_e4m3fn or v_slab.dtype != k_slab.dtype:
        raise TypeError(f"{name}: the slab must be float8_e4m3fn, got "
                        f"{k_slab.dtype}, {v_slab.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError(f"{name}: q / k_new / v_new must share one dtype of "
                        f"f32 or bf16, got {q.dtype}, {k_new.dtype}, "
                        f"{v_new.dtype}")
    if v_slab.shape != k_slab.shape or q.shape != (B, 1, H * Dh) or \
            k_new.shape != (B, 1, H, Dh) or v_new.shape != (B, 1, H, Dh):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, slab "
                         f"{tuple(k_slab.shape)} / {tuple(v_slab.shape)}, "
                         f"k_new {tuple(k_new.shape)}, v_new "
                         f"{tuple(v_new.shape)}")
    if Dh not in RING_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not in {RING_HEAD_DIMS}")
    for t in (x_lens, prefix_lens, t_lane):
        if t.dtype != torch.int64 or t.shape != (B,):
            raise ValueError(f"{name}: x_lens / prefix_lens / t_lane must be "
                             f"int64 [B]")
    if gstep.dtype != torch.int64 or gstep.dim() != 0:
        raise ValueError(f"{name}: gstep must be a 0-d int64 tensor")
    if not (0 <= x_pad <= y_start < S and 1 <= W):
        raise ValueError(f"{name}: bad geometry x_pad {x_pad}, y_start "
                         f"{y_start}, W {W} for S_max {S}")
    strides = [_lane_stride(n, t) for n, t in
               (("q", q), ("k_new", k_new), ("v_new", v_new))]
    out = torch.empty((B, 1, H * Dh), dtype=q.dtype, device=q.device)
    err = _native.lib().vc_ring_decode_attention(
        q.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), *strides, x_lens.data_ptr(), prefix_lens.data_ptr(),
        t_lane.data_ptr(), gstep.data_ptr(), out.data_ptr(), B, S, H, Dh,
        x_pad, y_start, W, 1.0 / math.sqrt(Dh), _native.DTYPE_CODES[q.dtype],
        _native.stream(q))
    _native.check(err, name)
    _native.count_launch(name)
    return out
