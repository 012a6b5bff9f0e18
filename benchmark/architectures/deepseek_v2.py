"""VoiceCraft with DeepSeek-V2's decoder (ModelConfig.block "deepseek_v2"),
as the benchmark sees it: random weights made from the seed, and the FLOP
and byte counts of its shapes.

The block: latent attention (W_q, W_kva, W_kvb, W_o, no bias; RMSNorm
gains before it and on the latent), then a dense SwiGLU (layers below
first_k_dense_replace) or the expert layer (router, routed SwiGLU experts,
shared experts as one SwiGLU), RMSNorm before each and at the end.
VoiceCraft's embeddings, alphas and four two-layer heads around it.

Weights.  Keyed as the port's ``load_state_dict`` reads them, drawn on the
device from one generator: the front end and the heads as
architectures/voicecraft.py draws them, then layer by layer (so that the
float32 draws of one layer, about 2 GB at DeepSeek-V2-Lite's widths, are
all that is held beside the state), each matrix uniform within its
fan-in's bound and each gain 1 + U(-0.1, 0.1).

Counts.  A multiply-add is 2 FLOPs; active parameters only: a token
multiplies the attention and the dense FFN, or the attention, its k routed
experts, the shared experts and the router.  Attention is counted in the
published, unabsorbed form, 2 H (dn + dr + dv) FLOPs a key a layer, so
whether the program absorbs W_kvb never moves ``mfu``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

FLOAT = torch.float32


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


def _dims(cfg: dict):
    return (cfg["d_model"], cfg["nhead"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"])


def _layer_shapes(cfg: dict, li: int) -> Dict[str, tuple]:
    """Each matrix of layer li: its shape (fan-in second to last)."""
    D, H, r, dn, dr, dv = _dims(cfg)
    out = {"wq": (D, H * (dn + dr)), "wkv_a": (D, r + dr),
           "wkv_b": (r, H * (dn + dv)), "wo": (H * dv, D)}
    if li < cfg["first_k_dense_replace"]:
        I = cfg["intermediate_size"]
        out.update(w1=(D, 2 * I), w2=(I, D))
    else:
        E, Ie = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        Is = cfg["n_shared_experts"] * Ie
        out.update(router=(D, E), experts_w1=(E, D, 2 * Ie),
                   experts_w2=(E, Ie, D), shared_w1=(D, 2 * Is),
                   shared_w2=(Is, D))
    return out


def make_state(cfg: dict, seed: int, device, matrix_dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` for ``seed``: matrices in ``matrix_dtype``,
    embeddings, alphas, gains and head biases in f32."""
    if cfg.get("block") != "deepseek_v2":
        raise ValueError(f"architecture deepseek_v2 needs block "
                         f"'deepseek_v2', not {cfg.get('block')!r}")
    g = _gen(seed, device)
    L, D, K = cfg["num_decoder_layers"], cfg["d_model"], cfg["n_codebooks"]
    r = cfg["kv_lora_rank"]
    card = cfg["audio_vocab_size"] + cfg["n_special"]
    half = cfg["audio_vocab_size"] // 2

    def uni(shape, bound, dtype=matrix_dtype):
        t = torch.rand(shape, generator=g, device=device, dtype=FLOAT)
        return t.mul_(2 * bound).sub_(bound).to(dtype)

    def normal(shape):
        return torch.randn(shape, generator=g, device=device, dtype=FLOAT)

    st = {"text_emb": normal((cfg["text_vocab_size"] + 1, D)),
          "audio_emb": normal((K, card, D)),
          "mask_emb": normal((cfg["max_n_spans"], D)),
          "alpha_text": 1.0 + uni((), 0.1, FLOAT),
          "alpha_audio": 1.0 + uni((), 0.1, FLOAT),
          "heads.w1": uni((K, D, half), D ** -0.5),
          "heads.b1": uni((K, half), D ** -0.5, FLOAT),
          "heads.w2": uni((K, half, card), half ** -0.5),
          "heads.b2": uni((K, card), half ** -0.5, FLOAT)}
    for li in range(L):
        p = f"decoder.layers.{li}."
        st[p + "ln1_g"] = 1.0 + uni((D,), 0.1, FLOAT)
        st[p + "kv_ln_g"] = 1.0 + uni((r,), 0.1, FLOAT)
        st[p + "ln2_g"] = 1.0 + uni((D,), 0.1, FLOAT)
        for name, shape in _layer_shapes(cfg, li).items():
            st[p + name] = uni(shape, shape[-2] ** -0.5)
    st["decoder.final_ln_g"] = 1.0 + uni((D,), 0.1, FLOAT)
    return st


# ---- counts ---------------------------------------------------------------------

def _attn_params(cfg: dict) -> int:
    return sum(a * b for a, b in
               (s for n, s in _layer_shapes(cfg, 0).items()
                if n in ("wq", "wkv_a", "wkv_b", "wo")))


def _expert_params(cfg: dict) -> int:
    """One routed expert: gate, up and down."""
    return 3 * cfg["d_model"] * cfg["moe_intermediate_size"]


def layer_active_params(cfg: dict) -> List[int]:
    """Weights one token multiplies in each layer: the attention and the
    dense SwiGLU, or the attention, k routed experts, the shared experts
    and the router."""
    D, attn = cfg["d_model"], _attn_params(cfg)
    dense = attn + 3 * D * cfg["intermediate_size"]
    sparse = (attn + (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
              * _expert_params(cfg) + D * cfg["n_routed_experts"])
    k = cfg["first_k_dense_replace"]
    return [dense] * k + [sparse] * (cfg["num_decoder_layers"] - k)


def decoder_params(cfg: dict) -> int:
    """Every matrix of the stack (norm gains aside)."""
    return sum(math.prod(s) for li in range(cfg["num_decoder_layers"])
               for s in _layer_shapes(cfg, li).values())


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies in one expert layer (the stack's
    common layer; :func:`layer_active_params` gives each layer's)."""
    return layer_active_params(cfg)[-1]


def head_matmul_params(cfg: dict) -> int:
    D, K, V = cfg["d_model"], cfg["n_codebooks"], cfg["audio_vocab_size"]
    half, card = V // 2, V + cfg["n_special"]
    return K * (D * half + half * card)


def _attn_flops_per_key(cfg: dict) -> float:
    """Scores and p.v of one query against one key in one layer, in the
    unabsorbed form: 2 H (dn + dr) + 2 H dv."""
    _, H, _, dn, dr, dv = _dims(cfg)
    return 2.0 * H * (dn + dr + dv)


def decode_token_flops(cfg: dict, keys: int) -> float:
    """One decode step of one lane whose query sees ``keys`` positions
    (its own included): every layer's active products and attention, and
    the heads."""
    L = cfg["num_decoder_layers"]
    return (2.0 * (sum(layer_active_params(cfg)) + head_matmul_params(cfg))
            + L * _attn_flops_per_key(cfg) * keys)


def prefill_flops(cfg: dict, tokens: int) -> float:
    """A causal prefill of ``tokens`` positions, heads at the last one."""
    L = cfg["num_decoder_layers"]
    return (2.0 * tokens * sum(layer_active_params(cfg))
            + 2.0 * head_matmul_params(cfg)
            + L * _attn_flops_per_key(cfg) * tokens * (tokens + 1) / 2.0)


def expert_product_bytes(cfg: dict, rows_per_expert) -> float:
    """The routed experts' grouped products over one expert layer's rows
    ``rows_per_expert`` [E]: each touched expert's three matrices once in
    bf16, and its rows in and out of both products (x [D] in and the
    gate/up output [2 Ie] out, the hidden [Ie] in and [D] out), bf16."""
    D, Ie = cfg["d_model"], cfg["moe_intermediate_size"]
    rows = [int(n) for n in rows_per_expert]
    touched = sum(1 for n in rows if n > 0)
    return (touched * _expert_params(cfg) * 2.0
            + sum(rows) * (D + 2 * Ie + Ie + D) * 2.0)
