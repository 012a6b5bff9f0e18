"""Weights into the port: from the JAX package's parameter pytrees, and from
the reference PyTorch VoiceCraft ``state_dict`` (PyTorch port of
voicecraft_tpu/utils/convert.py).

The ``from_*`` functions return a ``state_dict`` for the port's modules
(``models.voicecraft.VoiceCraft`` / ``models.encodec.Encodec``); load it with
``module.load_state_dict(state)``, which casts each tensor to the module's
storage dtype.  The JAX decoder's per-layer parameters are stacked [L, ...]
and its matrices are [in, out], the port's own layout.
:func:`to_reference_state_dict` goes the other way, from the port's state to
the reference's.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig

from ..models.encodec import EncodecConfig
from ..models.transformer import FFN_KEYS

State = Dict[str, torch.Tensor]


def to_torch(a) -> torch.Tensor:
    """Array-like (numpy, JAX, torch) -> CPU torch tensor of the same dtype.
    ml_dtypes arrays (bfloat16, float8_e4m3fn, as JAX arrays come out of
    ``np.asarray``) travel through an integer view of their bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))   # a writable copy


def _ffn_lin1(ffn: dict, cfg: ModelConfig) -> dict:
    """The first FFN projection, whose key name encodes the activation
    (lin1, lin1_gelu, lin1_dsw, lin1_bdsw); it must be cfg's."""
    key = next(k for k in ffn if k.startswith("lin1"))
    want = FFN_KEYS[cfg.ffn_activation]
    if key != want:
        raise ValueError(f"the tree's FFN projection {key!r} is not that of "
                         f"ffn_activation {cfg.ffn_activation!r} ({want!r})")
    return ffn[key]


def _norm_entries(prefix: str, p: dict) -> State:
    """A JAX norm's parameters ({"g", "b"}, {"log_eps"}, {"log_eps_bal"} or
    none) as ``{prefix}_{key}`` entries."""
    return {f"{prefix}_{k}": v for k, v in p.items()}


def _matrix(st: State, key: str, w) -> None:
    """A weight matrix into the state: plain, or a weight-only fp8 dict
    (utils/quantize.py) as ``key.q`` / ``key.scale``, bit for bit."""
    if isinstance(w, dict):
        st[key + ".q"] = to_torch(w["q"])
        st[key + ".scale"] = to_torch(w["scale"])
    else:
        st[key] = to_torch(w)


def _heads(st: State, prefix: str, heads: dict) -> None:
    for name in ("w1", "w2"):
        _matrix(st, f"{prefix}.{name}", heads[name])
    for name in ("b1", "b2"):
        st[f"{prefix}.{name}"] = to_torch(heads[name])


def _unstack(st: State, n: int, sub: State) -> State:
    """Entries stacked along a leading axis of n -> one entry per index,
    ``{prefix}.{i}.{rest}``; sub maps (prefix, rest) keys."""
    for (prefix, rest), v in sub.items():
        for i in range(n):
            st[f"{prefix}.{i}.{rest}"] = v[i]
    return st


def from_jax_params(tree: dict, cfg: ModelConfig) -> State:
    """The JAX package's ``init_params``-style pytree (arrays or numpy) ->
    the port's VoiceCraft state.  Weight-only fp8 trees of
    ``quantize_decoder_fp8`` (packed qkv or not) carry across bit for bit:
    load them into a model of the same layout
    (``utils.quantize.quantize_decoder_fp8(model, pack_qkv)``).  The MTP
    heads [n_mtp, K, ...] become ``mtp_heads.{j}``.  Every norm family and
    FFN activation carries across (BasicNorm's log_eps, the identity's
    empty norm, the lin1_* projection); a tree whose FFN projection is not
    cfg.ffn_activation's raises ValueError."""
    t = to_torch
    lay = tree["decoder"]["layers"]
    attn, ffn = lay["attn"], lay["ffn"]
    lin1 = _ffn_lin1(ffn, cfg)
    st: State = {
        "text_emb": t(tree["text_emb"]["weight"]),
        "audio_emb": t(tree["audio_emb"]),
        "mask_emb": t(tree["mask_emb"]),
        "alpha_text": t(tree["alpha_text"]).reshape(()),
        "alpha_audio": t(tree["alpha_audio"]).reshape(()),
    }
    st.update({k: t(v) for k, v in _norm_entries(
        "decoder.final_ln", tree["decoder"]["final_ln"]).items()})
    _heads(st, "heads", tree["heads"])
    stacked: State = {}
    per_layer = {
        **_norm_entries("ln1", lay["ln1"]), **_norm_entries("ln2", lay["ln2"]),
        "wo": attn["out"]["w"], "bo": attn["out"]["b"],
        "w1": lin1["w"], "b1": lin1["b"],
        "w2": ffn["lin2"]["w"], "b2": ffn["lin2"]["b"],
    }
    qkv = ("wqkv", "bqkv") if "wqkv" in attn else ("wq", "wk", "wv",
                                                   "bq", "bk", "bv")
    per_layer.update({name: attn[name] for name in qkv})
    for name, w in per_layer.items():
        _matrix(stacked, name, w)
    _unstack(st, cfg.num_decoder_layers,
             {("decoder.layers", k): v for k, v in stacked.items()})
    if "mtp_heads" in tree:
        mtp: State = {}
        _heads(mtp, "h", tree["mtp_heads"])
        n = next(iter(mtp.values())).shape[0]
        _unstack(st, n, {("mtp_heads", k[2:]): v for k, v in mtp.items()})
    return st


def _reference_layout(cfg: ModelConfig) -> None:
    """The reference layout maps LayerNorm + relu models only."""
    if cfg.norm != "layernorm" or cfg.ffn_activation != "relu":
        raise ValueError(
            f"the reference state_dict layout maps only norm 'layernorm' with "
            f"ffn_activation 'relu'; this model has norm {cfg.norm!r} and "
            f"ffn_activation {cfg.ffn_activation!r}")


def from_reference_state_dict(sd: dict, cfg: ModelConfig) -> State:
    """A reference VoiceCraft state_dict (packed attention in-proj [3D, D],
    torch Linear [out, in] weights) -> the port's VoiceCraft state.  Only
    LayerNorm + relu configs (ValueError otherwise)."""
    _reference_layout(cfg)
    K, D, L = cfg.n_codebooks, cfg.d_model, cfg.num_decoder_layers
    g = lambda k: to_torch(sd[k]).float()
    st: State = {
        "text_emb": g("text_embedding.word_embeddings.weight"),
        "audio_emb": torch.stack([g(f"audio_embedding.{k}.word_embeddings.weight")
                                  for k in range(K)]),
        "mask_emb": g("mask_embedding"),
        "alpha_text": g("text_positional_embedding.alpha").reshape(()),
        "alpha_audio": g("audio_positional_embedding.alpha").reshape(()),
        "decoder.final_ln_g": g("decoder.norm.weight"),
        "decoder.final_ln_b": g("decoder.norm.bias"),
        "heads.w1": torch.stack([g(f"predict_layer.{k}.0.weight").T
                                 for k in range(K)]),
        "heads.b1": torch.stack([g(f"predict_layer.{k}.0.bias") for k in range(K)]),
        "heads.w2": torch.stack([g(f"predict_layer.{k}.2.weight").T
                                 for k in range(K)]),
        "heads.b2": torch.stack([g(f"predict_layer.{k}.2.bias") for k in range(K)]),
    }
    for i in range(L):
        p = f"decoder.layers.{i}."        # the same prefix in both layouts
        inw = g(p + "self_attn.in_proj_weight")                # [3D, D]
        inb = g(p + "self_attn.in_proj_bias")
        st.update({
            p + "wq": inw[:D].T, p + "wk": inw[D:2 * D].T, p + "wv": inw[2 * D:].T,
            p + "bq": inb[:D], p + "bk": inb[D:2 * D], p + "bv": inb[2 * D:],
            p + "wo": g(p + "self_attn.out_proj.weight").T,
            p + "bo": g(p + "self_attn.out_proj.bias"),
            p + "ln1_g": g(p + "norm1.weight"), p + "ln1_b": g(p + "norm1.bias"),
            p + "ln2_g": g(p + "norm2.weight"), p + "ln2_b": g(p + "norm2.bias"),
            p + "w1": g(p + "linear1.weight").T, p + "b1": g(p + "linear1.bias"),
            p + "w2": g(p + "linear2.weight").T, p + "b2": g(p + "linear2.bias"),
        })
    return {k: v.contiguous() for k, v in st.items()}


def to_reference_state_dict(state: Mapping[str, torch.Tensor],
                            cfg: ModelConfig) -> State:
    """The port's VoiceCraft state (``model.state_dict()`` or a trainer
    checkpoint's) -> the reference's state_dict, f32 CPU tensors: the
    inverse of :func:`from_reference_state_dict`.  Only LayerNorm + relu
    models map (ValueError otherwise); MTP heads are dropped, with a
    warning."""
    _reference_layout(cfg)
    K, L = cfg.n_codebooks, cfg.num_decoder_layers
    if any(k.startswith("mtp_heads.") for k in state):
        logging.getLogger(__name__).warning(
            "exporting to the reference format drops the MTP heads "
            "(speculative decoding); keep the trainer checkpoint if you need "
            "them")
    g = lambda k: to_torch(state[k]).float()
    out: State = {"text_embedding.word_embeddings.weight": g("text_emb")}
    audio = g("audio_emb")
    for k in range(K):
        out[f"audio_embedding.{k}.word_embeddings.weight"] = audio[k]
    out["mask_embedding"] = g("mask_emb")
    out["text_positional_embedding.alpha"] = g("alpha_text").reshape(1)
    out["audio_positional_embedding.alpha"] = g("alpha_audio").reshape(1)
    for i in range(L):
        p = f"decoder.layers.{i}."
        out[p + "self_attn.in_proj_weight"] = torch.cat(
            [g(p + "wq").T, g(p + "wk").T, g(p + "wv").T], dim=0)
        out[p + "self_attn.in_proj_bias"] = torch.cat(
            [g(p + "bq"), g(p + "bk"), g(p + "bv")], dim=0)
        out[p + "self_attn.out_proj.weight"] = g(p + "wo").T
        out[p + "self_attn.out_proj.bias"] = g(p + "bo")
        out[p + "norm1.weight"] = g(p + "ln1_g")
        out[p + "norm1.bias"] = g(p + "ln1_b")
        out[p + "norm2.weight"] = g(p + "ln2_g")
        out[p + "norm2.bias"] = g(p + "ln2_b")
        out[p + "linear1.weight"] = g(p + "w1").T
        out[p + "linear1.bias"] = g(p + "b1")
        out[p + "linear2.weight"] = g(p + "w2").T
        out[p + "linear2.bias"] = g(p + "b2")
    out["decoder.norm.weight"] = g("decoder.final_ln_g")
    out["decoder.norm.bias"] = g("decoder.final_ln_b")
    for name, idx in (("w1", 0), ("w2", 2)):
        w, b = g(f"heads.{name}"), g(f"heads.b{name[1]}")
        for k in range(K):
            out[f"predict_layer.{k}.{idx}.weight"] = w[k].T
            out[f"predict_layer.{k}.{idx}.bias"] = b[k]
    return {k: v.contiguous() for k, v in out.items()}


def load_reference_bundle(path: str):
    """A reference ``best_bundle.pth`` -> (ModelConfig, state, phn2num).
    Unpickles with ``weights_only=False``: load only bundles you trust."""
    bundle = torch.load(path, map_location="cpu", weights_only=False)
    args = bundle["config"]
    cfg = ModelConfig.from_dict(vars(args) if not isinstance(args, dict) else args)
    return cfg, from_reference_state_dict(bundle["model"], cfg), bundle.get("phn2num")


def codec_from_jax_params(tree: dict, ccfg: EncodecConfig) -> State:
    """The JAX package's ``init_encodec``-style codec pytree -> the port's
    Encodec state.  Conv weights [K, Cin, Cout] and transposed-conv weights
    [K, Cout, Cin] both become PyTorch's layout by reversing the axes."""
    st: State = {}

    def conv(prefix: str, p: dict) -> None:
        st[prefix + ".weight"] = to_torch(p["w"]).permute(2, 1, 0).contiguous()
        st[prefix + ".bias"] = to_torch(p["b"])

    def lstm(prefix: str, p: dict) -> None:
        for i, layer in enumerate(p["layers"]):
            for ours, theirs in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                 ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                st[f"{prefix}.lstm.{ours}_l{i}"] = to_torch(layer[theirs])

    def blocks(prefix: str, blks: list) -> None:
        for j, blk in enumerate(blks):
            for name in ("conv1", "conv2", "shortcut"):
                if name in blk:
                    conv(f"{prefix}.blocks.{j}.{name}", blk[name])

    enc, dec = tree["encoder"], tree["decoder"]
    conv("encoder.init", enc["init"])
    for s, stage in enumerate(enc["stages"]):
        blocks(f"encoder.stages.{s}", stage["blocks"])
        conv(f"encoder.stages.{s}.down", stage["down"])
    conv("encoder.final", enc["final"])
    conv("decoder.init", dec["init"])
    for s, stage in enumerate(dec["stages"]):
        conv(f"decoder.stages.{s}.up", stage["up"])
        blocks(f"decoder.stages.{s}", stage["blocks"])
    conv("decoder.final", dec["final"])
    if ccfg.lstm:
        lstm("encoder.lstm", enc["lstm"])
        lstm("decoder.lstm", dec["lstm"])
    st["codebooks"] = to_torch(tree["codebooks"])
    return st
