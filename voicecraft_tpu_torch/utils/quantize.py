"""Weight-only fp8 quantization of the decoder (PyTorch port of
voicecraft_tpu/utils/quantize.py).

Batch-1 decode streams every decoder weight once per token, so storing the
matrices as float8_e4m3fn with one bf16 scale per output column halves the
bytes a step must read.  The decoder's q/k/v (or the packed qkv), out and
both FFN projections (``w1`` under every activation: the JAX package's
lin1 / lin1_gelu / lin1_dsw / lin1_bdsw), the prediction heads and the MTP
heads are quantized; embeddings, norms and biases stay as they are.  The
fp8 decoder of a model whose activation is not relu serves through the
unfused FFN, as the JAX package's does.

Per-output-column scales commute with the contraction, so
    x @ w == (x @ (w / s)) * s
up to the fp8 rounding of w / s.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..ops.attention import matmul_f32

FP8_MAX = 448.0  # float8_e4m3fn's largest normal


class FP8Weight(nn.Module):
    """A weight-only fp8 matrix: ``q`` float8_e4m3fn [..., in, out] and its
    per-output-column ``scale`` bf16 [..., 1, out], both buffers (no
    gradient)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def extra_repr(self) -> str:
        return f"shape={tuple(self.q.shape)}"


def _quantize_matrix(w: torch.Tensor) -> FP8Weight:
    """w [..., in, out] -> FP8Weight: the column absmax over 448 (at least
    1e-12) in f32 divides w in f32 before the cast to e4m3; the stored
    scale is that f32 scale cast to bf16."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax / FP8_MAX, min=1e-12)
    q = (wf / scale).to(torch.float8_e4m3fn)
    return FP8Weight(q, scale.to(torch.bfloat16))


def is_quantized(w) -> bool:
    return isinstance(w, FP8Weight) or (isinstance(w, dict) and "q" in w
                                        and "scale" in w)


def dequant_dot(x: torch.Tensor, w, preferred: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """x @ w for a plain or quantized w (ops.attention.matmul_f32's shapes:
    a stack of K heads [K, in, out] too), the product in f32 and returned
    in ``preferred``; an fp8 weight's scale [..., 1, out] multiplies after
    the product."""
    if not is_quantized(w):
        return matmul_f32(x, w.to(x.dtype)).to(preferred)
    q, scale = (w["q"], w["scale"]) if isinstance(w, dict) else (w.q, w.scale)
    y = matmul_f32(x, q.to(x.dtype)).to(preferred)
    return y * scale.to(y.dtype)


def _replace(module: nn.Module, name: str, value) -> None:
    delattr(module, name)
    setattr(module, name, value)


def _quantize_heads(heads: nn.Module) -> None:
    for name in ("w1", "w2"):
        _replace(heads, name, _quantize_matrix(getattr(heads, name)))


def quantize_decoder_fp8(model: nn.Module, pack_qkv: bool = False) -> nn.Module:
    """A copy of ``model`` (a ``models.voicecraft.VoiceCraft``) with its
    decoder matrices, prediction heads and MTP heads quantized.

    ``pack_qkv`` concatenates wq|wk|wv into one [D, 3D] matrix ``wqkv``
    (and the biases into ``bqkv``) before quantizing, so a step does one
    product instead of three; column scales commute with the concat, so
    packing is exact."""
    model = copy.deepcopy(model)
    for layer in model.decoder.layers:
        if pack_qkv:
            wqkv = torch.cat([layer.wq, layer.wk, layer.wv], dim=-1)
            bqkv = torch.cat([layer.bq, layer.bk, layer.bv], dim=-1)
            for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
                delattr(layer, name)
            layer.wqkv = _quantize_matrix(wqkv)
            layer.bqkv = nn.Parameter(bqkv, requires_grad=False)
        else:
            for name in ("wq", "wk", "wv"):
                _replace(layer, name, _quantize_matrix(getattr(layer, name)))
        for name in ("wo", "w1", "w2"):
            _replace(layer, name, _quantize_matrix(getattr(layer, name)))
    _quantize_heads(model.heads)
    for heads in getattr(model, "mtp_heads", None) or ():
        _quantize_heads(heads)
    return model
