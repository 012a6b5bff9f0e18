"""The decode-step FFN in one kernel, and its plain version (PyTorch port of
voicecraft_tpu/ops/fused_decode.py).

    out = relu(x @ w1 * s1 + b1) @ w2 * s2 + b2

``fused_ffn`` launches csrc/fused_ffn.cu for CUDA tensors and takes the
plain version for CPU tensors; there is no fallback between the two.
Weights are [in, out] matrices in x's dtype, or ``{'q': float8_e4m3fn
[in, out], 'scale': [out] or [1, out]}`` dicts with per-output-channel
scales (the layout of voicecraft_tpu/utils/quantize.py).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import _native

Weight = Union[torch.Tensor, dict]

FFN_TILE_F = 64           # hidden columns per block (csrc/fused_ffn.cu)
FFN_MAX_ROWS = 8          # decode rows per call


def _split(w: Weight) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if isinstance(w, dict):
        return w["q"], w["scale"].reshape(-1)
    return w, None


def fused_ffn_plain(x: torch.Tensor, w1: Weight, b1: torch.Tensor,
                    w2: Weight, b2: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the TPU kernel's
    numerics: weights cast to x's dtype, f32 products, scale and bias in
    f32, the hidden activation cast to x's dtype before the second
    product.  x: [B, D] -> [B, D] in x's dtype."""
    w1q, s1 = _split(w1)
    w2q, s2 = _split(w2)
    h = x.float() @ w1q.to(x.dtype).float()
    if s1 is not None:
        h = h * s1.float()
    h = torch.relu(h + b1.float()).to(x.dtype)
    out = h.float() @ w2q.to(x.dtype).float()
    if s2 is not None:
        out = out * s2.float()
    return (out + b2.float()).to(x.dtype)


def fused_ffn(x: torch.Tensor, w1: Weight, b1: torch.Tensor, w2: Weight,
              b2: torch.Tensor) -> torch.Tensor:
    """relu(x @ w1 + b1) @ w2 + b2 for a few decode rows x: [B, D].

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2)
    name = "fused_ffn"
    w1q, s1 = _split(w1)
    w2q, s2 = _split(w2)
    s1 = None if s1 is None else s1.float().contiguous()
    s2 = None if s2 is None else s2.float().contiguous()
    scales = [s for s in (s1, s2) if s is not None]
    _native.require_cuda(name, x, w1q, b1, w2q, b2, *scales)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [B, D], got {tuple(x.shape)}")
    B, D = x.shape
    F = w1q.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    if w2q.dtype != w1q.dtype or w1q.dtype not in (x.dtype, torch.float8_e4m3fn):
        raise TypeError(f"{name}: weights must both be {x.dtype} or "
                        f"float8_e4m3fn, got {w1q.dtype} and {w2q.dtype}")
    if (w1q.dtype == torch.float8_e4m3fn) != (len(scales) == 2):
        raise ValueError(f"{name}: fp8 weights need their scales, and only "
                         "fp8 weights take scales")
    if b1.dtype != x.dtype or b2.dtype != x.dtype:
        raise TypeError(f"{name}: biases must be {x.dtype}")
    if (w1q.shape != (D, F) or w2q.shape != (F, D) or b1.shape != (F,)
            or b2.shape != (D,) or (s1 is not None and s1.shape != (F,))
            or (s2 is not None and s2.shape != (D,))):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, "
                         f"w1 {tuple(w1q.shape)}, w2 {tuple(w2q.shape)}")
    if not 1 <= B <= FFN_MAX_ROWS:
        raise ValueError(f"{name}: takes 1..{FFN_MAX_ROWS} rows, got {B}")
    n_tiles = -(-F // FFN_TILE_F)
    partial = torch.empty((n_tiles, B, D), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _native.lib().vc_fused_ffn(
        x.data_ptr(), w1q.data_ptr(), None if s1 is None else s1.data_ptr(),
        b1.data_ptr(), w2q.data_ptr(), None if s2 is None else s2.data_ptr(),
        b2.data_ptr(), partial.data_ptr(), out.data_ptr(), B, D, F,
        FFN_TILE_F, _native.DTYPE_CODES[x.dtype],
        _native.DTYPE_CODES[w1q.dtype], _native.stream(x))
    _native.check(err, name)
    _native.LAUNCHES[name] += 1
    return out
