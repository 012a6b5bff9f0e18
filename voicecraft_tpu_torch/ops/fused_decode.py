"""The decode-step FFN in one kernel, and its plain version (PyTorch port of
voicecraft_tpu/ops/fused_decode.py).

    out = relu(x @ w1 * s1 + b1) @ w2 * s2 + b2

``fused_ffn`` takes the plain version for CPU tensors.  For CUDA tensors it
launches one kernel, chosen by ``ffn_route``: bf16 x (the card's path) the
Hopper kernel of csrc/fused_ffn_sm90.cu, f32 x (the checks) the simple
kernel of csrc/fused_ffn.cu; anything else raises.  There is no fallback
between any of them.  Weights are [in, out] matrices in x's dtype, or
``{'q': float8_e4m3fn [in, out], 'scale': [out] or [1, out]}`` dicts or
utils/quantize.py:FP8Weight modules with per-output-channel scales.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import _native

Weight = Union[torch.Tensor, dict]

FFN_TILE_F = 64           # hidden columns per tile, both kernels
FFN_MAX_ROWS = 8          # decode rows per call (the sm90 kernel's mma n)
FFN_MAX_BLOCKS = 128      # sm90: blocks per call, one an SM, all resident
FFN_SM90_MAX_D = 2048     # sm90: the widest preset

# the sm90 kernel's grid-barrier counter, one zeroed int per device; each
# launch leaves it zeroed, and calls on one device must not overlap in time
_BARRIERS = {}


def ffn_route(x_dtype: torch.dtype, w_dtype: torch.dtype, B: int, D: int,
              F: int) -> str:
    """The kernel that fused_ffn launches for CUDA tensors: "sm90" (bf16 x,
    csrc/fused_ffn_sm90.cu) or "f32" (csrc/fused_ffn.cu).  Raises TypeError
    or ValueError for what neither takes."""
    if x_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_ffn: x must be f32 or bf16, got {x_dtype}")
    if w_dtype not in (x_dtype, torch.float8_e4m3fn):
        raise TypeError(f"fused_ffn: weights must both be {x_dtype} or "
                        f"float8_e4m3fn, got {w_dtype}")
    if not 1 <= B <= FFN_MAX_ROWS:
        raise ValueError(f"fused_ffn: takes 1..{FFN_MAX_ROWS} rows, got {B}")
    if x_dtype == torch.float32:
        return "f32"
    if D % 64 or F % FFN_TILE_F or not 64 <= D <= FFN_SM90_MAX_D:
        raise ValueError(f"fused_ffn: bf16 takes D and F in multiples of 64 "
                         f"with D <= {FFN_SM90_MAX_D}, got D {D}, F {F}")
    return "sm90"


def ffn_sm90_blocks(F: int) -> int:
    """The sm90 kernel's block count: one per 64-column tile of F, at most
    FFN_MAX_BLOCKS."""
    return min(FFN_MAX_BLOCKS, F // FFN_TILE_F)


def ffn_sm90_tiles(F: int) -> list:
    """The hidden tiles each block of the sm90 kernel owns, split as the
    kernel splits them (block i: tiles [i*T//n, (i+1)*T//n))."""
    n, tiles = ffn_sm90_blocks(F), F // FFN_TILE_F
    return [range(i * tiles // n, (i + 1) * tiles // n) for i in range(n)]


def _split(w: Weight) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if isinstance(w, torch.Tensor):
        return w, None
    if isinstance(w, dict):
        return w["q"], w["scale"].reshape(-1)
    return w.q, w.scale.reshape(-1)       # utils/quantize.py:FP8Weight


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
              b2: torch.Tensor, trace: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """relu(x @ w1 + b1) @ w2 + b2 for a few decode rows x: [B, D].

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  ``trace``, for measurement, is an int64 CUDA tensor
    [ffn_sm90_blocks(F), 4] that the sm90 kernel fills with each block's
    %globaltimer ns at its start, at the end of its weight stream, when the
    grid barrier lets it pass and at its end."""
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
    if w2q.dtype != w1q.dtype:
        raise TypeError(f"{name}: w1 and w2 differ in dtype, {w1q.dtype} and "
                        f"{w2q.dtype}")
    route = ffn_route(x.dtype, w1q.dtype, B, D, F)
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
    if route == "sm90":
        grid = ffn_sm90_blocks(F)
        if trace is not None and (trace.dtype != torch.int64
                                  or trace.shape != (grid, 4)
                                  or trace.device != x.device):
            raise ValueError(f"{name}: trace must be int64 [{grid}, 4] on "
                             f"{x.device}")
        dev = x.device.index
        if dev not in _BARRIERS:
            _BARRIERS[dev] = torch.zeros(1, dtype=torch.int32, device=x.device)
        barrier = _BARRIERS[dev].data_ptr()
    else:
        if trace is not None:
            raise ValueError(f"{name}: only the bf16 kernel is traced")
        grid = -(-F // FFN_TILE_F)
        barrier = None
    # f32 partials of out, one [B, D] per block of either kernel
    scratch = torch.empty((grid, B, D), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _native.lib().vc_fused_ffn(
        x.data_ptr(), w1q.data_ptr(), None if s1 is None else s1.data_ptr(),
        b1.data_ptr(), w2q.data_ptr(), None if s2 is None else s2.data_ptr(),
        b2.data_ptr(), scratch.data_ptr(), barrier, out.data_ptr(), B, D, F,
        grid, _native.DTYPE_CODES[x.dtype], _native.DTYPE_CODES[w1q.dtype],
        None if trace is None else trace.data_ptr(), _native.stream(x))
    _native.check(err, name)
    _native.count_launch(name, f"{route}/{_native.DTYPE_NAMES[w1q.dtype]}")
    return out
