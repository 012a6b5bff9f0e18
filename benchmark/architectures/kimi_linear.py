"""VoiceCraft with Kimi Linear's decoder (ModelConfig.block "kimi_linear"),
as the benchmark sees it: random weights made from the seed, and the FLOP
and byte counts of its shapes.

The block: KDA layers (the layers ``kda_layers`` lists, 1-indexed: q | k |
v projection, short convolutions, the decay's and the output gate's
low-rank pairs, beta, the head norm's gain and W_o) and latent attention
without rotary positions in the others (W_q, W_kva, W_kvb, W_o), then a
dense SwiGLU (layers below first_k_dense_replace) or the expert layer (a
router of the published width with its correction bias, the held routed
SwiGLU experts, one shared), RMSNorm before each and at the end.
VoiceCraft's embeddings, alphas and four two-layer heads around it.

Weights.  Keyed as the port's ``load_state_dict`` reads them, drawn on the
device from one generator: the front end and the heads as
architectures/voicecraft.py draws them, then layer by layer (so that one
layer's float32 draws, about 1.8 GB at Kimi-Linear-48B-A3B's widths with
64 experts held, are all that is held beside the state): every matrix
uniform within its fan-in's bound, the convolutions' taps within 1 /
sqrt(width), every RMSNorm gain 1 + U(-0.1, 0.1), A_log = ln U(1, 16),
dt_bias the inverse softplus of dt = exp U(ln 1e-3, ln 0.1) (Mamba's dt
init), the output gate's bias within its fan-in's bound and the router's
correction bias U(-0.01, 0.01).

Counts.  A multiply-add is 2 FLOPs; active parameters only: a token
multiplies the attention (KDA's or the latent one's) and the dense FFN,
or the attention, its routed experts that are held here (k E / E_router
of them in expectation: 2 of the published 8, since this chip holds 64 of
256), the shared expert and the router.  KDA's recurrence is 6 dk dv
FLOPs a head a token (decay, S^T k, the rank-one update and S^T q); the
latent attention is counted in the published, unabsorbed form, 2 H (dn +
dr + dv) FLOPs a key a layer.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

FLOAT = torch.float32


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


def _is_kda(cfg: dict) -> List[bool]:
    kda = set(cfg["kda_layers"])
    return [li + 1 in kda for li in range(cfg["num_decoder_layers"])]


def _router_experts(cfg: dict) -> int:
    return cfg.get("router_experts") or cfg["n_routed_experts"]


def _attn_shapes(cfg: dict, kda: bool) -> Dict[str, tuple]:
    """A layer's attention matrices: shape each, fan-in second to last."""
    D = cfg["d_model"]
    if kda:
        H, dk = cfg["kda_num_heads"], cfg["kda_head_dim"]
        HK = H * dk
        return {"w_qkv": (D, 3 * HK), "w_fa": (D, dk), "w_fb": (dk, HK),
                "w_b": (D, H), "w_ga": (D, dk), "w_gb": (dk, HK),
                "wo": (HK, D)}
    H, r = cfg["nhead"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    return {"wq": (D, H * (dn + dr)), "wkv_a": (D, r + dr),
            "wkv_b": (r, H * (dn + dv)), "wo": (H * dv, D)}


def _ffn_shapes(cfg: dict, li: int) -> Dict[str, tuple]:
    D = cfg["d_model"]
    if li < cfg["first_k_dense_replace"]:
        I = cfg["intermediate_size"]
        return {"w1": (D, 2 * I), "w2": (I, D)}
    E, Ie = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    Is = cfg["n_shared_experts"] * Ie
    return {"router": (D, _router_experts(cfg)), "experts_w1": (E, D, 2 * Ie),
            "experts_w2": (E, Ie, D), "shared_w1": (D, 2 * Is),
            "shared_w2": (Is, D)}


def _conv_shape(cfg: dict) -> tuple:
    return (3 * cfg["kda_num_heads"] * cfg["kda_head_dim"],
            cfg["kda_conv_size"])


def make_state(cfg: dict, seed: int, device, matrix_dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` for ``seed``: matrices (and the
    convolutions' taps) in ``matrix_dtype``; embeddings, alphas, gains,
    biases, A_log and head biases in f32."""
    if cfg.get("block") != "kimi_linear":
        raise ValueError(f"architecture kimi_linear needs block "
                         f"'kimi_linear', not {cfg.get('block')!r}")
    g = _gen(seed, device)
    D, K = cfg["d_model"], cfg["n_codebooks"]
    r = cfg["kv_lora_rank"]
    card = cfg["audio_vocab_size"] + cfg["n_special"]
    half = cfg["audio_vocab_size"] // 2
    H, dk = cfg["kda_num_heads"], cfg["kda_head_dim"]

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
    for li, kda in enumerate(_is_kda(cfg)):
        p = f"decoder.layers.{li}."
        st[p + "ln1_g"] = 1.0 + uni((D,), 0.1, FLOAT)
        for name, shape in _attn_shapes(cfg, kda).items():
            st[p + name] = uni(shape, shape[-2] ** -0.5)
        if kda:
            conv = _conv_shape(cfg)
            st[p + "conv_w"] = uni(conv, conv[1] ** -0.5)
            dt = torch.rand((H * dk,), generator=g, device=device,
                            dtype=FLOAT)
            dt = (dt * (math.log(0.1) - math.log(1e-3))
                  + math.log(1e-3)).exp()
            st[p + "dt_bias"] = dt + torch.log(-torch.expm1(-dt))
            st[p + "A_log"] = (1.0 + uni((H,), 7.5, FLOAT) + 7.5).log()
            st[p + "b_gb"] = uni((H * dk,), dk ** -0.5, FLOAT)
            st[p + "o_norm_g"] = 1.0 + uni((dk,), 0.1, FLOAT)
        else:
            st[p + "kv_ln_g"] = 1.0 + uni((r,), 0.1, FLOAT)
        st[p + "ln2_g"] = 1.0 + uni((D,), 0.1, FLOAT)
        for name, shape in _ffn_shapes(cfg, li).items():
            st[p + name] = uni(shape, shape[-2] ** -0.5)
        if cfg.get("router_bias") and li >= cfg["first_k_dense_replace"]:
            st[p + "router_bias"] = uni((_router_experts(cfg),), 0.01, FLOAT)
    st["decoder.final_ln_g"] = 1.0 + uni((D,), 0.1, FLOAT)
    return st


# ---- counts ---------------------------------------------------------------------

def _expert_params(cfg: dict) -> int:
    """One routed expert: gate, up and down."""
    return 3 * cfg["d_model"] * cfg["moe_intermediate_size"]


def _attn_params(cfg: dict, kda: bool) -> int:
    n = sum(math.prod(s) for s in _attn_shapes(cfg, kda).values())
    return n + (math.prod(_conv_shape(cfg)) if kda else 0)


def layer_active_params(cfg: dict) -> List[float]:
    """Weights one token multiplies in each layer: the attention and the
    dense SwiGLU, or the attention, the held routed experts it reaches in
    expectation (k E / E_router), the shared experts and the router."""
    D = cfg["d_model"]
    routed = (cfg["num_experts_per_tok"] * cfg["n_routed_experts"]
              / _router_experts(cfg))
    out = []
    for li, kda in enumerate(_is_kda(cfg)):
        attn = _attn_params(cfg, kda)
        if li < cfg["first_k_dense_replace"]:
            out.append(attn + 3 * D * cfg["intermediate_size"])
        else:
            out.append(attn + (routed + cfg["n_shared_experts"])
                       * _expert_params(cfg) + D * _router_experts(cfg))
    return out


def decoder_params(cfg: dict) -> int:
    """Every matrix of the stack and the convolutions' taps (gains, biases
    and A_log aside), with the experts held here."""
    return sum(_attn_params(cfg, kda)
               + sum(math.prod(s) for s in _ffn_shapes(cfg, li).values())
               for li, kda in enumerate(_is_kda(cfg)))


def layer_matmul_params(cfg: dict) -> float:
    """Weights one token multiplies in the last layer (a latent-attention
    expert layer; :func:`layer_active_params` gives each layer's)."""
    return layer_active_params(cfg)[-1]


def head_matmul_params(cfg: dict) -> int:
    D, K, V = cfg["d_model"], cfg["n_codebooks"], cfg["audio_vocab_size"]
    half, card = V // 2, V + cfg["n_special"]
    return K * (D * half + half * card)


def _attn_flops_per_key(cfg: dict) -> float:
    """Scores and p.v of one query against one key in one latent layer,
    in the unabsorbed form: 2 H (dn + dr) + 2 H dv."""
    H = cfg["nhead"]
    return 2.0 * H * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                      + cfg["v_head_dim"])


def _kda_flops_per_token(cfg: dict) -> float:
    """One token's recurrence in every KDA layer: 6 dk dv a head."""
    dk = cfg["kda_head_dim"]
    return (sum(_is_kda(cfg)) * cfg["kda_num_heads"] * 6.0 * dk * dk)


def _n_latent(cfg: dict) -> int:
    return cfg["num_decoder_layers"] - sum(_is_kda(cfg))


def decode_token_flops(cfg: dict, keys: int) -> float:
    """One decode step of one lane whose query sees ``keys`` positions
    (its own included): every layer's active products, the recurrences,
    the latent layers' attention, and the heads."""
    return (2.0 * (sum(layer_active_params(cfg)) + head_matmul_params(cfg))
            + _kda_flops_per_token(cfg)
            + _n_latent(cfg) * _attn_flops_per_key(cfg) * keys)


def prefill_flops(cfg: dict, tokens: int) -> float:
    """A causal prefill of ``tokens`` positions, heads at the last one."""
    return (2.0 * tokens * sum(layer_active_params(cfg))
            + 2.0 * head_matmul_params(cfg)
            + tokens * _kda_flops_per_token(cfg)
            + _n_latent(cfg) * _attn_flops_per_key(cfg)
            * tokens * (tokens + 1) / 2.0)


def expert_product_bytes(cfg: dict, rows_per_expert) -> float:
    """The routed experts' grouped products over one expert layer's rows
    ``rows_per_expert`` [E] (the held experts'): each touched expert's
    three matrices once in bf16, and its rows in and out of both products
    (x [D] in and the gate/up output [2 Ie] out, the hidden [Ie] in and [D]
    out), bf16."""
    D, Ie = cfg["d_model"], cfg["moe_intermediate_size"]
    rows = [int(n) for n in rows_per_expert]
    touched = sum(1 for n in rows if n > 0)
    return (touched * _expert_params(cfg) * 2.0
            + sum(rows) * (D + 2 * Ie + Ie + D) * 2.0)


def kda_step_bytes(cfg: dict, lanes: int) -> float:
    """One decode step's recurrence in one KDA layer over ``lanes`` lanes:
    the f32 state [H, dk, dv] read and written once, q, k and v (bf16), g
    (f32, per key channel), beta (f32, per head) and o (f32) once."""
    H, dk = cfg["kda_num_heads"], cfg["kda_head_dim"]
    state = 2 * 4 * H * dk * dk
    io = H * (3 * dk * 2 + dk * 4 + 4 + dk * 4)
    return float(lanes * (state + io))
