"""Pre-norm transformer decoder for training, prefill and decode (PyTorch
port of voicecraft_tpu/models/transformer.py).

Pre-norm layers with separate q/k/v projections, an FFN of width
4*d_model and a final norm.  The norm family and the FFN activation are the
config's (``ModelConfig.norm`` / ``ffn_activation``): LayerNorm (eps 1e-5),
BasicNorm, BalancedBasicNorm or the identity, and relu, exact-erf gelu,
DoubleSwish or BalancedDoubleSwish (models/scaling.py).  Each layer and the
decoder record their family by site ("ln1", "ln2", "final_ln"); every
forward goes through :func:`apply_norm` and :func:`ffn_block`.  Norm
parameters (LayerNorm's g/b, BasicNorm's log_eps) are f32; norms are
computed in f32.  Weight matrices are stored in the [in, out] layout
(x @ w): once in the compute dtype for inference, or weight-only fp8 after
utils/quantize.py:quantize_decoder_fp8; in the parameter dtype (f32 master
weights, cast to the compute dtype at each product) for training.

Training runs the stack through ``apply_stack``, with dropout whose masks
are seeded per (step seed, layer, site) inside the region that draws them,
and a recompute policy through torch.utils.checkpoint.  As in the JAX
package, the norms take their train form (BasicNorm's expected ballast)
exactly when a dropout seed is given.

The KV cache is a preallocated slab
[L, 2, B, S_max, H, Dh] (k at 0, v at 1) that prefill fills and each decode
step (or speculative block) updates once, in place, at ``pos`` (lockstep
serving: at each lane's own offset).  The slab is in the compute dtype or,
for serving, in float8_e4m3fn: k/v are cast to the slab's dtype where they
are written and upcast to q's dtype where each layer reads them, as the
JAX package does (``.astype``); a slab in q's dtype is read in place.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import (decode_attention_multi,
                             decode_attention_multi_block,
                             decode_attention_self, decode_attention_self_block,
                             dropout)
from ..ops import fused_decode
from ..parallel.mesh import copy_to_model, reduce_model
from . import scaling


def _param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# each norm family's parameters by suffix ("ln1" + "_g", ...): the keys of
# the JAX package's _norm_init; the identity has none
NORM_PARAMS = {"layernorm": ("g", "b"), "basicnorm": ("log_eps",),
               "balancedbasicnorm": ("log_eps_bal",), "identity": ()}
# BasicNorm's eps in the transformer's norms (the reference's family
# wrappers pass layer_norm_eps; scaling.basic_norm_init keeps 0.25)
BASIC_NORM_EPS = 1e-5

# the FFN activations (reference transformer.py _get_activation_fn and the
# icefall activations), and the JAX package's first-projection key of each
FFN_ACTS = {
    "relu": torch.relu,
    "gelu": lambda h: F.gelu(h, approximate="none"),
    "doubleswish": scaling.double_swish,
    "balanceddoubleswish": scaling.balanced_double_swish,
}
FFN_KEYS = {"relu": "lin1", "gelu": "lin1_gelu", "doubleswish": "lin1_dsw",
            "balanceddoubleswish": "lin1_bdsw"}


def _check_family(norm: str, activation: str) -> None:
    if norm not in NORM_PARAMS:
        raise ValueError(f"unknown norm {norm!r}; expected layernorm | "
                         "basicnorm | balancedbasicnorm | identity")
    if activation not in FFN_ACTS:
        raise ValueError(f"unknown activation {activation!r}; expected one "
                         f"of {sorted(FFN_ACTS)}")


def _add_norm(module: nn.Module, site: str, kind: str, D: int, device) -> None:
    """The parameters of norm ``kind`` at ``site``, f32: g/b [D], log_eps 0-d."""
    module.norm_kinds[site] = kind
    for suffix in NORM_PARAMS[kind]:
        shape = (D,) if suffix in ("g", "b") else ()
        setattr(module, f"{site}_{suffix}",
                _param(*shape, dtype=torch.float32, device=device))


@torch.no_grad()
def _init_norm(module: nn.Module, site: str) -> None:
    for suffix in NORM_PARAMS[module.norm_kinds[site]]:
        t = getattr(module, f"{site}_{suffix}")
        t.fill_({"g": 1.0, "b": 0.0}.get(suffix, math.log(BASIC_NORM_EPS)))


class DecoderLayer(nn.Module):
    """One layer's parameters.  ``norm`` is the pre-attention norm; the
    pre-FFN norm is the same family, except that the identity's is
    balancedbasicnorm (reference transformer.py:245-252).  ``mesh``: the
    parallel.mesh.Mesh whose 'model' axis shards the layer (set by
    ``shard_params``), else None."""

    mesh = None

    def __init__(self, d_model: int, ffn_dim: int, dtype: torch.dtype, device,
                 norm: str = "layernorm", activation: str = "relu"):
        super().__init__()
        _check_family(norm, activation)
        D = d_model
        self.norm_kinds = {}
        self.activation = activation
        _add_norm(self, "ln1", norm, D, device)
        self.wq = _param(D, D, dtype=dtype, device=device)
        self.wk = _param(D, D, dtype=dtype, device=device)
        self.wv = _param(D, D, dtype=dtype, device=device)
        self.bq = _param(D, dtype=dtype, device=device)
        self.bk = _param(D, dtype=dtype, device=device)
        self.bv = _param(D, dtype=dtype, device=device)
        self.wo = _param(D, D, dtype=dtype, device=device)
        self.bo = _param(D, dtype=dtype, device=device)
        _add_norm(self, "ln2",
                  "balancedbasicnorm" if norm == "identity" else norm, D,
                  device)
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
        for w in (self.bq, self.bk, self.bv):
            w.zero_()
        _init_norm(self, "ln1")
        _init_norm(self, "ln2")
        for w, b, fan_in in ((self.wo, self.bo, D), (self.w1, self.b1, D),
                             (self.w2, self.b2, Fd)):
            bound = fan_in ** -0.5
            w.uniform_(-bound, bound, generator=generator)
            b.uniform_(-bound, bound, generator=generator)


class Decoder(nn.Module):
    """The layer stack plus the final norm: ``norm``'s family, except
    layernorm after an identity stack (the reference always passes
    LayerNorm there, voicecraft.py:175).  ``activation`` is the FFN's.
    ``nhead`` is this rank's number of heads: nhead / n_model once
    ``shard_params`` has sharded the stack over a mesh's 'model' axis."""

    mesh = None

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 ffn_dim: int, dtype: torch.dtype, device,
                 norm: str = "layernorm", activation: str = "relu"):
        super().__init__()
        _check_family(norm, activation)
        self.nhead = nhead
        self.activation = activation
        self.norm_kinds = {}
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, ffn_dim, dtype, device, norm, activation)
            for _ in range(num_layers))
        _add_norm(self, "final_ln",
                  "layernorm" if norm == "identity" else norm, d_model, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init_weights(generator)
        _init_norm(self, "final_ln")


# ---- primitives ---------------------------------------------------------------

def layer_norm(g: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 with f32 params, returned in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), g, b, eps).to(x.dtype)


def apply_norm(module: nn.Module, site: str, x: torch.Tensor,
               train: bool = False) -> torch.Tensor:
    """The norm at ``site`` of ``module`` (a DecoderLayer's "ln1" / "ln2",
    the Decoder's "final_ln") on x, in x's dtype.  ``train`` selects
    BasicNorm's train form (scaling.basic_norm)."""
    kind = module.norm_kinds[site]
    if kind == "layernorm":
        return layer_norm(getattr(module, site + "_g"),
                          getattr(module, site + "_b"), x)
    if kind == "basicnorm":
        return scaling.basic_norm(x, getattr(module, site + "_log_eps"),
                                  train=train)
    if kind == "balancedbasicnorm":
        return scaling.balanced_basic_norm(
            x, getattr(module, site + "_log_eps_bal"), train=train)
    return x


def adaptive_layer_norm_init(generator: torch.Generator, d_model: int,
                             dtype=torch.float32, norm: str = "layernorm"
                             ) -> nn.Module:
    """AdaptiveLayerNorm's parameters (reference transformer.py:84-115): a
    d_model -> 2 d_model projection ``project_w`` / ``project_b`` of a
    conditioning embedding and an inner norm ("norm" site).  The VoiceCraft
    configs do not use it."""
    dev = generator.device
    m = nn.Module()
    m.norm_kinds = {}
    bound = d_model ** -0.5
    m.project_w = _param(d_model, 2 * d_model, dtype=dtype, device=dev)
    m.project_b = _param(2 * d_model, dtype=dtype, device=dev)
    with torch.no_grad():
        m.project_w.uniform_(-bound, bound, generator=generator)
        m.project_b.uniform_(-bound, bound, generator=generator)
    _add_norm(m, "norm", norm, d_model, dev)
    _init_norm(m, "norm")
    return m


def adaptive_layer_norm(m: nn.Module, x: torch.Tensor,
                        embedding: torch.Tensor) -> torch.Tensor:
    """weight * norm(x) + bias, (weight, bias) = split(proj(embedding))."""
    wb = _proj(embedding, m.project_w, m.project_b)
    weight, bias = wb.chunk(2, dim=-1)
    return weight * apply_norm(m, "norm", x) + bias


def _proj(x: torch.Tensor, w, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's dtype.  A weight-only fp8 ``w``
    (utils/quantize.py:FP8Weight) rounds as the JAX package's does: the
    product to x's dtype, then times the scale cast to x's dtype, plus the
    bias."""
    if isinstance(w, torch.Tensor):
        return x @ w.to(x.dtype) + b.to(x.dtype)
    y = x @ w.q.to(x.dtype)
    return y * w.scale.reshape(1, -1).to(x.dtype) + b.to(x.dtype)


def row_proj(layer: DecoderLayer, x: torch.Tensor, w, b: torch.Tensor
             ) -> torch.Tensor:
    """A row-parallel x @ w + b (the attention's out projection, the FFN's
    second): under a mesh's 'model' axis, each rank's partial product over
    its rows, summed over 'model' in x's dtype (each rank's product rounded
    once from cuBLAS's f32 accumulator, then the sum of the n_model
    roundings: about one ulp a layer from one card's single rounding), then
    the bias, once.  Without a model split, :func:`_proj`."""
    mesh = getattr(layer, "mesh", None)
    if mesh is None or mesh.n_model == 1:
        return _proj(x, w, b)
    return reduce_model(x @ w.to(x.dtype), mesh) + b.to(x.dtype)


def qkv_proj(layer: DecoderLayer, h: torch.Tensor):
    """q, k, v (this rank's heads under a mesh's 'model' axis); one
    product split along its last axis for the packed ``wqkv`` of
    ``quantize_decoder_fp8(pack_qkv=True)``."""
    h = copy_to_model(h, getattr(layer, "mesh", None))
    if hasattr(layer, "wqkv"):
        return _proj(h, layer.wqkv, layer.bqkv).chunk(3, dim=-1)
    return (_proj(h, layer.wq, layer.bq), _proj(h, layer.wk, layer.bk),
            _proj(h, layer.wv, layer.bv))


def ffn_hidden(layer: DecoderLayer, h: torch.Tensor) -> torch.Tensor:
    """The FFN's hidden activation, act(lin1(h)) (this rank's columns under
    a mesh's 'model' axis)."""
    h = copy_to_model(h, getattr(layer, "mesh", None))
    return FFN_ACTS[layer.activation](_proj(h, layer.w1, layer.b1))


def ffn_block(layer: DecoderLayer, h: torch.Tensor) -> torch.Tensor:
    """lin1 -> the layer's activation -> lin2 (row-parallel)."""
    return row_proj(layer, ffn_hidden(layer, h), layer.w2, layer.b2)


# ---- training forward --------------------------------------------------------------

# the layer stack's recompute policies (config.ModelConfig.train_remat)
REMAT_POLICIES = ("full", "dots", "attn", "attn_ffn1", "none")


def fold_seed(seed: Optional[int], *path: int) -> Optional[int]:
    """A 63-bit seed derived from ``seed`` and a path of ints (layer, site,
    ...); None stays None (no dropout)."""
    if seed is None:
        return None
    state = np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _checkpoint(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


# the products of a layer's projections: [*, in] @ [in, out] reaches aten as
# mm (addmm where a bias is fused)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint_dots(fn, *args):
    """Checkpoint that keeps every projection's product and recomputes
    the rest (the norms, the activation, dropout, residuals)."""
    return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda:
                      create_selective_checkpoint_contexts(_dots_policy))


def _call(fn, *args):
    return fn(*args)


def _attn_inputs(layer: DecoderLayer, x: torch.Tensor, train: bool):
    return qkv_proj(layer, apply_norm(layer, "ln1", x, train))


def _ffn_in(layer: DecoderLayer, x: torch.Tensor, a: torch.Tensor,
            rate: float, seed: Optional[int]):
    """The residual after the attention's out projection, and the FFN's
    hidden activation act(lin1(norm2(x))) ("ffn1"); the norm in its train
    form when ``seed`` is given."""
    x = x + dropout(row_proj(layer, a, layer.wo, layer.bo), rate,
                    fold_seed(seed, 1))
    h = apply_norm(layer, "ln2", x, train=seed is not None)
    return x, ffn_hidden(layer, h)


def _ffn_out(layer: DecoderLayer, x: torch.Tensor, f: torch.Tensor,
             rate: float, seed: Optional[int]) -> torch.Tensor:
    f = row_proj(layer, dropout(f, rate, _local_seed(layer, seed, 2)),
                 layer.w2, layer.b2)
    return x + dropout(f, rate, fold_seed(seed, 3))


def _local_seed(layer: DecoderLayer, seed: Optional[int], site: int
                ) -> Optional[int]:
    """The seed of a dropout site over this rank's heads or FFN columns:
    under a 'model' split each rank draws its own columns' mask."""
    mesh = getattr(layer, "mesh", None)
    if mesh is None or mesh.n_model == 1:
        return fold_seed(seed, site)
    return fold_seed(seed, site, mesh.model_rank)


def _ffn_half(layer, x, a, rate, seed):
    return _ffn_out(layer, *_ffn_in(layer, x, a, rate, seed), rate, seed)


def apply_layer(layer: DecoderLayer, x: torch.Tensor, attn: Callable,
                rate: float = 0.0, seed: Optional[int] = None,
                remat: str = "none") -> torch.Tensor:
    """One pre-norm layer, x + SA(norm1(x)) then + FFN(norm2(x)), with
    dropout ``rate`` at the attention output, the FFN hidden and the FFN
    output (sites 1-3; the attention's own is site 0) when ``seed`` is
    given; the norms take their train form exactly then, as the JAX
    package's ``train = rng is not None``.

    ``attn(q, k, v, seed)`` is the training attention.  It must keep only
    q/k/v for its backward: chunked_attention does through its per-chunk
    checkpoints; forward_train puts the dense mha under a checkpoint of its
    own for every policy but "full" and "none".  ``remat``:
      "none"       nothing recomputed;
      "full"       the whole layer under one checkpoint (keeps x);
      "attn"       the norm1 + q/k/v projections and the FFN half each under
                   a checkpoint: the attention output is kept, so the
                   backward never recomputes the attention forward
                   (keeps x, q, k, v and the attention output);
      "attn_ffn1"  "attn" with the FFN half split after the activation,
                   keeping its hidden activation too;
      "dots"       the "attn" regions under selective checkpointing that
                   keeps every projection's product.
    Policies change memory and time, never values."""
    if remat == "full":
        return _checkpoint(apply_layer, layer, x, attn, rate, seed, "none")
    region = {"none": _call, "dots": _checkpoint_dots}.get(remat, _checkpoint)
    q, k, v = region(_attn_inputs, layer, x, seed is not None)
    a = attn(q, k, v, _local_seed(layer, seed, 0))
    if remat == "attn_ffn1":
        x, f = _checkpoint(_ffn_in, layer, x, a, rate, seed)
        return _checkpoint(_ffn_out, layer, x, f, rate, seed)
    return region(_ffn_half, layer, x, a, rate, seed)


def apply_stack(decoder: Decoder, x: torch.Tensor, attn: Callable,
                rate: float = 0.0, seed: Optional[int] = None,
                remat: str = "none") -> torch.Tensor:
    """The training forward of the stack over x [B, S, D]: every layer
    (layer li's dropout seeded from (seed, li)), then the final norm (in
    its train form when ``seed`` is given).  See :func:`apply_layer` for
    ``attn`` and ``remat``."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; expected one of "
                         f"{REMAT_POLICIES}")
    for li, layer in enumerate(decoder.layers):
        x = apply_layer(layer, x, attn, rate, fold_seed(seed, li), remat)
    return apply_norm(decoder, "final_ln", x, train=seed is not None)


# ---- prefill / decode with KV slab ---------------------------------------------

def init_kv_cache(num_layers: int, batch: int, s_max: int, nhead: int,
                  head_dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Slab cache [L, 2, B, S_max, H, Dh] (k at index 0, v at index 1) in
    ``dtype`` (the compute dtype, or torch.float8_e4m3fn).  Under a mesh,
    B is this rank's lanes (B / n_data) and H its heads (H / n_model)."""
    return torch.zeros((num_layers, 2, batch, s_max, nhead, head_dim),
                       dtype=dtype, device=device)


def _layer_slab(cache: torch.Tensor, li: int, dtype: torch.dtype):
    """Layer li's k and v slabs [B, S_max, H, Dh] in ``dtype``: views of the
    slab when it is in that dtype, else its upcast (an fp8 slab: exact in
    bf16 or f32, one [B, S_max, H, Dh] copy per layer and step)."""
    k, v = cache[li, 0], cache[li, 1]
    if cache.dtype == dtype:
        return k, v
    return k.to(dtype), v.to(dtype)


def _stored(cache: torch.Tensor, kv: torch.Tensor):
    """(slab, kv) to write kv into the slab in place: kv cast to the slab's
    dtype (torch's round-to-nearest-even ``.to``), and an fp8 slab and its
    kv seen as bytes (index_copy_ has no fp8 kernel)."""
    kv = kv.to(cache.dtype)
    if cache.dtype == torch.float8_e4m3fn:
        return cache.view(torch.uint8), kv.view(torch.uint8)
    return cache, kv


def _store_kv(cache: torch.Tensor, dim: int, index: torch.Tensor,
              kv: torch.Tensor) -> None:
    """cache.index_copy_(dim, index, kv), in place, through _stored."""
    slab, kv = _stored(cache, kv)
    slab.index_copy_(dim, index, kv)


def prefill(decoder: Decoder, x: torch.Tensor,
            attn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
            cache: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward that also fills cache[:, :, :, :S] (in place).

    x: [B, S, D]; ``attn(q, k, v)`` is the prefill attention (see
    ops.flash_attention.prefill_attention).  Returns (final-normed hidden
    [B, S, D], cache)."""
    B, S, _ = x.shape
    H = decoder.nhead
    for li, layer in enumerate(decoder.layers):
        q, k, v = qkv_proj(layer, apply_norm(layer, "ln1", x))
        x = x + row_proj(layer, attn(q, k, v), layer.wo, layer.bo)
        x = x + ffn_block(layer, apply_norm(layer, "ln2", x))
        cache[li, 0, :, :S] = k.view(B, S, H, -1)
        cache[li, 1, :, :S] = v.view(B, S, H, -1)
    return apply_norm(decoder, "final_ln", x), cache


def _layer_stack(decoder: Decoder, x_t: torch.Tensor, cache: torch.Tensor,
                 attend, ffn=None, raw_slab: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer stack of every decode forward against a READ-ONLY slab:
    attend(q, k_slab, v_slab, k_new, v_new) is the forward's decode
    attention (the T new tokens' k/v enter it as extra terms), and
    ffn(layer, h) the feed-forward block (default: the unfused
    :func:`ffn_block`).  The layer's slabs reach ``attend`` through
    :func:`_layer_slab` (in q's dtype), or with ``raw_slab`` as the cache's
    own views, for an attention that reads an fp8 slab in place.  The
    caller writes the returned k/v into the slab once.  Returns
    (final-normed hidden [B, T, D], the new k/v [L, 2, B, T, H, Dh]).
    Another block's decoder raises, naming it."""
    if not isinstance(decoder, Decoder):
        raise ValueError(f"this decode path serves VoiceCraft's block only, "
                         f"not block {getattr(decoder, 'block', '?')!r}")
    L, _, B, S_max, H, Dh = cache.shape
    T = x_t.shape[1]
    x = x_t
    kv = []
    for li, layer in enumerate(decoder.layers):
        q, k, v = qkv_proj(layer, apply_norm(layer, "ln1", x))
        k_new = k.reshape(B, T, H, Dh)
        v_new = v.reshape(B, T, H, Dh)
        k_slab, v_slab = ((cache[li, 0], cache[li, 1]) if raw_slab
                          else _layer_slab(cache, li, q.dtype))
        a = attend(q, k_slab, v_slab, k_new, v_new)
        x = x + row_proj(layer, a, layer.wo, layer.bo)
        h2 = apply_norm(layer, "ln2", x)
        x = x + (ffn_block(layer, h2) if ffn is None else ffn(layer, h2))
        kv.append(torch.stack([k_new, v_new]))                  # [2,B,T,H,Dh]
    return apply_norm(decoder, "final_ln", x), torch.stack(kv)


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
    mesh = getattr(decoder, "mesh", None)
    if fused_ffn and mesh is not None and mesh.n_model > 1:
        raise ValueError(
            "fused_ffn under a 'model' split: the kernel adds lin2's bias in "
            "its body, once per model rank (the JAX package's fused FFN "
            "serves only the unsharded single-stream loop)")
    if fused_ffn and decoder.activation != "relu":
        raise ValueError(
            "fused_ffn supports the relu FFN only (the kernel hard-codes "
            "relu); this model was built with ffn_activation != 'relu' "
            f"(ffn_activation {decoder.activation!r})")
    B, D, H = x_t.shape[0], x_t.shape[2], decoder.nhead
    ffn = None
    if fused_ffn:
        def ffn(layer, h):
            return fused_decode.fused_ffn(h.view(B, D), layer.w1, layer.b1,
                                          layer.w2, layer.b2).view(B, 1, D)
    h, kv = _layer_stack(
        decoder, x_t, cache,
        lambda q, ks, vs, kn, vn: decode_attention_self(
            q, ks, vs, pos, kn, vn, H, x_len=x_len, x_pad=x_pad), ffn)
    _store_kv(cache, 3, pos.view(1), kv)
    return h, cache


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
    H, T = decoder.nhead, x_t.shape[1]
    h, kv = _layer_stack(
        decoder, x_t, cache,
        lambda q, ks, vs, kn, vn: decode_attention_self_block(
            q, ks, vs, pos, kn, vn, H, x_len=x_len, x_pad=x_pad))
    _store_kv(cache, 3, pos + torch.arange(T, device=pos.device), kv)
    return h, cache


def decode_step_multi(decoder: Decoder, x_t: torch.Tensor, cache: torch.Tensor,
                      pos: torch.Tensor, x_lens: torch.Tensor, x_pad: int,
                      prefix_lens: torch.Tensor, y_start: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lockstep serving step: :func:`decode_step_fast` with per-lane text
    and prompt lengths (ops.attention.decode_attention_multi), a uniform
    write pointer ``pos`` (>= y_start) and the unfused FFN.

    x_t: [B, 1, D]; pos: 0-d; x_lens / prefix_lens: [B].  The caller keeps
    pos < S_max.  Returns (final-normed hidden [B, 1, D], cache)."""
    H = decoder.nhead
    h, kv = _layer_stack(
        decoder, x_t, cache,
        lambda q, ks, vs, kn, vn: decode_attention_multi(
            q, ks, vs, pos, kn, vn, H, x_lens, x_pad, prefix_lens, y_start))
    _store_kv(cache, 3, pos.view(1), kv)
    return h, cache


def decode_step_multi_block(decoder: Decoder, x_t: torch.Tensor,
                            cache: torch.Tensor, offsets: torch.Tensor,
                            x_lens: torch.Tensor, x_pad: int,
                            prefix_lens: torch.Tensor, y_start: int,
                            gen_lens: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative-serving forward: T tokens per lane in ONE pass, each lane
    written at its OWN slab offset.

    :func:`decode_step_block` with per-lane validity (ops.attention.
    decode_attention_multi_block: a compact generated region [y_start,
    y_start + gen_len_b) per lane); lane b's block lands at [offsets[b],
    offsets[b] + T) through one scatter over (lane, position).  Unlike
    JAX's scatter, which drops an index out of range, every index must lie
    in [0, S_max): the serving loops size the slab so (inference/
    serving.py), and an index out of range raises (a device-side assert on
    the card).

    x_t: [B, T, D]; offsets / gen_lens / x_lens / prefix_lens: [B].
    Returns (final-normed hidden [B, T, D], cache)."""
    B, H, T = cache.shape[2], decoder.nhead, x_t.shape[1]
    h, kv = _layer_stack(
        decoder, x_t, cache,
        lambda q, ks, vs, kn, vn: decode_attention_multi_block(
            q, ks, vs, gen_lens, kn, vn, H, x_lens, x_pad, prefix_lens,
            y_start))
    b_idx = torch.arange(B, device=offsets.device)[:, None]            # [B, 1]
    s_idx = offsets[:, None] + torch.arange(T, device=offsets.device)  # [B, T]
    slab, kv = _stored(cache, kv)
    slab[:, :, b_idx, s_idx] = kv
    return h, cache
