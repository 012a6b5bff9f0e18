"""Pre-norm transformer decoder for prefill and decode (PyTorch port of the
inference path of voicecraft_tpu/models/transformer.py).

Pre-norm LayerNorm (eps 1e-5, computed in f32), separate q/k/v
projections, ReLU FFN of width 4*d_model, final LayerNorm.  Weight matrices
are stored once in the compute dtype in the [in, out] layout (x @ w), or
weight-only fp8 after utils/quantize.py:quantize_decoder_fp8; LayerNorm
parameters stay f32.  The KV cache is a preallocated slab
[L, 2, B, S_max, H, Dh] (k at 0, v at 1) that prefill fills and each decode
step (or speculative block) updates once, in place, at ``pos``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import decode_attention_self, decode_attention_self_block
from ..ops import fused_decode


def _param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int, dtype: torch.dtype, device):
        super().__init__()
        D, f32 = d_model, torch.float32
        self.ln1_g = _param(D, dtype=f32, device=device)
        self.ln1_b = _param(D, dtype=f32, device=device)
        self.wq = _param(D, D, dtype=dtype, device=device)
        self.wk = _param(D, D, dtype=dtype, device=device)
        self.wv = _param(D, D, dtype=dtype, device=device)
        self.bq = _param(D, dtype=dtype, device=device)
        self.bk = _param(D, dtype=dtype, device=device)
        self.bv = _param(D, dtype=dtype, device=device)
        self.wo = _param(D, D, dtype=dtype, device=device)
        self.bo = _param(D, dtype=dtype, device=device)
        self.ln2_g = _param(D, dtype=f32, device=device)
        self.ln2_b = _param(D, dtype=f32, device=device)
        self.w1 = _param(D, ffn_dim, dtype=dtype, device=device)
        self.b1 = _param(ffn_dim, dtype=dtype, device=device)
        self.w2 = _param(ffn_dim, D, dtype=dtype, device=device)
        self.b2 = _param(D, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The distributions of the JAX package's ``init_layer``."""
        D, Fd = self.w1.shape
        limit = (6.0 / (D + 3 * D)) ** 0.5        # xavier on the packed [3D, D]
        for w in (self.wq, self.wk, self.wv):
            w.uniform_(-limit, limit, generator=generator)
        for w in (self.bq, self.bk, self.bv, self.ln1_b, self.ln2_b):
            w.zero_()
        self.ln1_g.fill_(1.0)
        self.ln2_g.fill_(1.0)
        for w, b, fan_in in ((self.wo, self.bo, D), (self.w1, self.b1, D),
                             (self.w2, self.b2, Fd)):
            bound = fan_in ** -0.5
            w.uniform_(-bound, bound, generator=generator)
            b.uniform_(-bound, bound, generator=generator)


class Decoder(nn.Module):
    """The layer stack plus the final LayerNorm.  ``activation`` names the
    FFN nonlinearity of the checkpoint; only relu is ported."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 ffn_dim: int, dtype: torch.dtype, device,
                 norm: str = "layernorm", activation: str = "relu"):
        super().__init__()
        if norm != "layernorm":
            raise NotImplementedError(f"norm {norm!r} is not yet ported "
                                      "(only layernorm)")
        self.nhead = nhead
        self.activation = activation
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, ffn_dim, dtype, device)
            for _ in range(num_layers))
        self.final_ln_g = _param(d_model, dtype=torch.float32, device=device)
        self.final_ln_b = _param(d_model, dtype=torch.float32, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init_weights(generator)
        self.final_ln_g.fill_(1.0)
        self.final_ln_b.zero_()


# ---- primitives ---------------------------------------------------------------

def layer_norm(g: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 with f32 params, returned in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), g, b, eps).to(x.dtype)


def _proj(x: torch.Tensor, w, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's dtype.  A weight-only fp8 ``w``
    (utils/quantize.py:FP8Weight) rounds as the JAX package's does: the
    product to x's dtype, then times the scale cast to x's dtype, plus the
    bias."""
    if isinstance(w, torch.Tensor):
        return x @ w.to(x.dtype) + b.to(x.dtype)
    y = x @ w.q.to(x.dtype)
    return y * w.scale.reshape(1, -1).to(x.dtype) + b.to(x.dtype)


def qkv_proj(layer: DecoderLayer, h: torch.Tensor):
    """q, k, v; one product split along its last axis for the packed
    ``wqkv`` of ``quantize_decoder_fp8(pack_qkv=True)``."""
    if hasattr(layer, "wqkv"):
        return _proj(h, layer.wqkv, layer.bqkv).chunk(3, dim=-1)
    return (_proj(h, layer.wq, layer.bq), _proj(h, layer.wk, layer.bk),
            _proj(h, layer.wv, layer.bv))


def ffn_block(layer: DecoderLayer, h: torch.Tensor,
              activation: str = "relu") -> torch.Tensor:
    if activation != "relu":
        raise NotImplementedError(f"ffn activation {activation!r} is not yet "
                                  "ported (only relu)")
    return _proj(torch.relu(_proj(h, layer.w1, layer.b1)), layer.w2, layer.b2)


# ---- prefill / decode with KV slab ---------------------------------------------

def init_kv_cache(num_layers: int, batch: int, s_max: int, nhead: int,
                  head_dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Slab cache [L, 2, B, S_max, H, Dh] (k at index 0, v at index 1)."""
    return torch.zeros((num_layers, 2, batch, s_max, nhead, head_dim),
                       dtype=dtype, device=device)


def prefill(decoder: Decoder, x: torch.Tensor,
            attn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
            cache: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward that also fills cache[:, :, :, :S] (in place).

    x: [B, S, D]; ``attn(q, k, v)`` is the prefill attention (see
    ops.flash_attention.prefill_attention).  Returns (final-normed hidden
    [B, S, D], cache)."""
    B, S, D = x.shape
    H = decoder.nhead
    for li, layer in enumerate(decoder.layers):
        h = layer_norm(layer.ln1_g, layer.ln1_b, x)
        q, k, v = qkv_proj(layer, h)
        a = _proj(attn(q, k, v), layer.wo, layer.bo)
        x = x + a
        x = x + ffn_block(layer, layer_norm(layer.ln2_g, layer.ln2_b, x),
                          decoder.activation)
        cache[li, 0, :, :S] = k.view(B, S, H, D // H)
        cache[li, 1, :, :S] = v.view(B, S, H, D // H)
    return layer_norm(decoder.final_ln_g, decoder.final_ln_b, x), cache


def decode_step_fast(decoder: Decoder, x_t: torch.Tensor, cache: torch.Tensor,
                     pos: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                     x_pad: Optional[int] = None, fused_ffn: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One autoregressive step with a WRITE-ONCE cache update.

    Every layer reads the slab read-only (the current token's k/v enter the
    attention as an extra term); one index_copy_ then writes all L layers'
    new k/v at ``pos``, in place.  ``fused_ffn`` routes the feed-forward
    block through the fused kernel (ops/fused_decode.py).

    x_t: [B, 1, D]; pos / x_len: 0-d integer tensors on the slab's device.
    Returns (final-normed hidden [B, 1, D], cache).
    """
    if fused_ffn and decoder.activation != "relu":
        raise ValueError(
            "fused_ffn supports the relu FFN only (the kernel hard-codes "
            f"relu); this model was built with ffn_activation "
            f"{decoder.activation!r}")
    L, _, B, S_max, H, Dh = cache.shape
    x = x_t
    kv = []
    for li, layer in enumerate(decoder.layers):
        h = layer_norm(layer.ln1_g, layer.ln1_b, x)
        q, k, v = qkv_proj(layer, h)
        k_new = k.view(B, 1, H, Dh)
        v_new = v.view(B, 1, H, Dh)
        a = decode_attention_self(q, cache[li, 0], cache[li, 1], pos, k_new,
                                  v_new, H, x_len=x_len, x_pad=x_pad)
        x = x + _proj(a, layer.wo, layer.bo)
        h2 = layer_norm(layer.ln2_g, layer.ln2_b, x)
        if fused_ffn:
            h2 = fused_decode.fused_ffn(h2.view(B, H * Dh), layer.w1, layer.b1,
                                        layer.w2, layer.b2).view(B, 1, H * Dh)
        else:
            h2 = ffn_block(layer, h2, decoder.activation)
        x = x + h2
        kv.append(torch.stack([k_new, v_new]))                  # [2,B,1,H,Dh]
    cache.index_copy_(3, pos.view(1), torch.stack(kv).to(cache.dtype))
    return layer_norm(decoder.final_ln_g, decoder.final_ln_b, x), cache


def decode_step_block(decoder: Decoder, x_t: torch.Tensor, cache: torch.Tensor,
                      pos: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                      x_pad: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feed T tokens through ONE forward against the slab (speculative
    decoding).

    The write-once structure of :func:`decode_step_fast`, with the block
    attending causally within itself (ops.attention.
    decode_attention_self_block); one index_copy_ writes all T tokens' k/v
    at [pos, pos + T).  Rewinding is moving ``pos`` back: entries at or
    beyond the next pass's ``pos`` are masked, never read.

    x_t: [B, T, D]; pos / x_len: 0-d integer tensors on the slab's device.
    Returns (final-normed hidden [B, T, D], cache).
    """
    L, _, B, S_max, H, Dh = cache.shape
    T = x_t.shape[1]
    x = x_t
    kv = []
    for li, layer in enumerate(decoder.layers):
        h = layer_norm(layer.ln1_g, layer.ln1_b, x)
        q, k, v = qkv_proj(layer, h)
        k_new = k.reshape(B, T, H, Dh)
        v_new = v.reshape(B, T, H, Dh)
        a = decode_attention_self_block(q, cache[li, 0], cache[li, 1], pos,
                                        k_new, v_new, H, x_len=x_len,
                                        x_pad=x_pad)
        x = x + _proj(a, layer.wo, layer.bo)
        x = x + ffn_block(layer, layer_norm(layer.ln2_g, layer.ln2_b, x),
                          decoder.activation)
        kv.append(torch.stack([k_new, v_new]))                  # [2,B,T,H,Dh]
    idx = pos + torch.arange(T, device=pos.device)
    cache.index_copy_(3, idx, torch.stack(kv).to(cache.dtype))
    return layer_norm(decoder.final_ln_g, decoder.final_ln_b, x), cache
