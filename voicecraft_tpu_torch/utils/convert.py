"""Weights into the port: from the JAX package's parameter pytrees, and from
the reference PyTorch VoiceCraft ``state_dict`` (PyTorch port of
voicecraft_tpu/utils/convert.py).

Each function returns a ``state_dict`` for the port's modules
(``models.voicecraft.VoiceCraft`` / ``models.encodec.Encodec``); load it with
``module.load_state_dict(state)``, which casts each tensor to the module's
storage dtype.  The JAX decoder's per-layer parameters are stacked [L, ...]
and its matrices are [in, out], the port's own layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from voicecraft_tpu.config import ModelConfig

from ..models.encodec import EncodecConfig

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


def _ffn_lin1(ffn: dict) -> dict:
    """The first FFN projection; its key name encodes the activation."""
    return next(v for k, v in ffn.items() if k.startswith("lin1"))


def from_jax_params(tree: dict, cfg: ModelConfig) -> State:
    """The JAX package's ``init_params``-style pytree (arrays or numpy) ->
    the port's VoiceCraft state."""
    t = to_torch
    lay = tree["decoder"]["layers"]
    attn, ffn = lay["attn"], lay["ffn"]
    if any(isinstance(w, dict) for w in (attn["wq"], attn["out"]["w"],
                                         ffn["lin2"]["w"])):
        raise NotImplementedError("fp8-quantized parameter trees are not yet "
                                  "ported")
    lin1 = _ffn_lin1(ffn)
    st: State = {
        "text_emb": t(tree["text_emb"]["weight"]),
        "audio_emb": t(tree["audio_emb"]),
        "mask_emb": t(tree["mask_emb"]),
        "alpha_text": t(tree["alpha_text"]).reshape(()),
        "alpha_audio": t(tree["alpha_audio"]).reshape(()),
        "decoder.final_ln_g": t(tree["decoder"]["final_ln"]["g"]),
        "decoder.final_ln_b": t(tree["decoder"]["final_ln"]["b"]),
    }
    for name in ("w1", "b1", "w2", "b2"):
        st[f"heads.{name}"] = t(tree["heads"][name])
    per_layer = {
        "ln1_g": lay["ln1"]["g"], "ln1_b": lay["ln1"]["b"],
        "wq": attn["wq"], "wk": attn["wk"], "wv": attn["wv"],
        "bq": attn["bq"], "bk": attn["bk"], "bv": attn["bv"],
        "wo": attn["out"]["w"], "bo": attn["out"]["b"],
        "ln2_g": lay["ln2"]["g"], "ln2_b": lay["ln2"]["b"],
        "w1": lin1["w"], "b1": lin1["b"],
        "w2": ffn["lin2"]["w"], "b2": ffn["lin2"]["b"],
    }
    for name, stacked in per_layer.items():
        stacked = t(stacked)
        for i in range(cfg.num_decoder_layers):
            st[f"decoder.layers.{i}.{name}"] = stacked[i]
    return st


def from_reference_state_dict(sd: dict, cfg: ModelConfig) -> State:
    """A reference VoiceCraft state_dict (packed attention in-proj [3D, D],
    torch Linear [out, in] weights) -> the port's VoiceCraft state."""
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
