"""VoiceCraft's decoder block, as the benchmark sees it: random weights made
from the seed, and the FLOP and byte counts of its shapes.

A configuration file names its architecture module with ``"architecture"``
(absent: this one).  The harness reaches the functions below through
``harness/weights.py`` and ``harness/counts.py``; a new architecture is a
file beside this one with the same functions.

The block: multi-head attention (q, k, v and out projections, each with a
bias), a dense FFN of 4 x d_model, two norms with a gain and a shift, and a
final norm; four codebook heads of two layers each.

Weights.  The state is keyed as the port's checkpoints are (the layout that
``VoiceCraft.load_state_dict`` reads) and is handed to the port through that
public load path, and to the reference.  Matrices are drawn per kind for
all layers at once, with the fan-in bounds of the published initialisation;
every bias and norm parameter is drawn too (not left at 0 or 1), so that a
path that drops one shows in the logits.

Counts.  A multiply-add is 2 FLOPs.  Only useful work is counted: attention
over the keys a query may see, not over a slab's padding; the heads where
the program applies them (the last prefill column and every decode step).
"""

from __future__ import annotations

from typing import Dict

import torch

FLOAT = torch.float32


# ---- weights --------------------------------------------------------------------

def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


def make_state(cfg: dict, seed: int, device, matrix_dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` (a configuration file's dict) for ``seed``:
    decoder and head matrices in ``matrix_dtype`` (the decoder's biases
    too), embeddings, alphas, norm parameters and head biases in f32."""
    g = _gen(seed, device)
    L, D = cfg["num_decoder_layers"], cfg["d_model"]
    Fd, K = 4 * D, cfg["n_codebooks"]
    card = cfg["audio_vocab_size"] + cfg["n_special"]
    half = cfg["audio_vocab_size"] // 2
    n_text = cfg["text_vocab_size"] + 1

    def uni(shape, bound, dtype=matrix_dtype):
        t = torch.rand(shape, generator=g, device=device, dtype=FLOAT)
        return t.mul_(2 * bound).sub_(bound).to(dtype)

    def normal(shape):
        return torch.randn(shape, generator=g, device=device, dtype=FLOAT)

    st = {"text_emb": normal((n_text, D)), "audio_emb": normal((K, card, D)),
          "mask_emb": normal((cfg["max_n_spans"], D)),
          "alpha_text": 1.0 + uni((), 0.1, FLOAT),
          "alpha_audio": 1.0 + uni((), 0.1, FLOAT)}
    xavier = (6.0 / (4 * D)) ** 0.5
    qkv = uni((L, 3, D, D), xavier)
    wo, w1, w2 = uni((L, D, D), D ** -0.5), uni((L, D, Fd), D ** -0.5), \
        uni((L, Fd, D), Fd ** -0.5)
    b_attn = uni((L, 4, D), D ** -0.5)
    b1, b2 = uni((L, Fd), D ** -0.5), uni((L, D), Fd ** -0.5)
    gains = 1.0 + uni((L + 1, 2, D), 0.1, FLOAT)
    shifts = uni((L + 1, 2, D), 0.1, FLOAT)
    for i in range(L):
        p = f"decoder.layers.{i}."
        st.update({p + "ln1_g": gains[i, 0], p + "ln1_b": shifts[i, 0],
                   p + "wq": qkv[i, 0], p + "wk": qkv[i, 1],
                   p + "wv": qkv[i, 2], p + "bq": b_attn[i, 0],
                   p + "bk": b_attn[i, 1], p + "bv": b_attn[i, 2],
                   p + "wo": wo[i], p + "bo": b_attn[i, 3],
                   p + "ln2_g": gains[i, 1], p + "ln2_b": shifts[i, 1],
                   p + "w1": w1[i], p + "b1": b1[i], p + "w2": w2[i],
                   p + "b2": b2[i]})
    st["decoder.final_ln_g"] = gains[L, 0]
    st["decoder.final_ln_b"] = shifts[L, 0]
    st.update({"heads.w1": uni((K, D, half), D ** -0.5),
               "heads.b1": uni((K, half), D ** -0.5, FLOAT),
               "heads.w2": uni((K, half, card), half ** -0.5),
               "heads.b2": uni((K, card), half ** -0.5, FLOAT)})
    return st


# ---- counts ---------------------------------------------------------------------

def _dims(cfg: dict):
    D = cfg["d_model"]
    return (cfg["num_decoder_layers"], D, 4 * D, cfg["n_codebooks"],
            cfg["audio_vocab_size"] // 2,
            cfg["audio_vocab_size"] + cfg["n_special"])


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies in one decoder layer: q, k, v, out and
    the two FFN projections."""
    _, D, Fd, _, _, _ = _dims(cfg)
    return 4 * D * D + 2 * D * Fd


def head_matmul_params(cfg: dict) -> int:
    _, D, _, K, half, card = _dims(cfg)
    return K * (D * half + half * card)


def decode_token_flops(cfg: dict, keys: int) -> float:
    """One decode step of one lane whose query sees ``keys`` positions
    (its own included): every layer's projections and attention, and the
    heads."""
    L, D = _dims(cfg)[:2]
    return (2.0 * (L * layer_matmul_params(cfg) + head_matmul_params(cfg))
            + L * 4.0 * D * keys)


def prefill_flops(cfg: dict, tokens: int) -> float:
    """A causal prefill of ``tokens`` positions, heads at the last one."""
    L, D = _dims(cfg)[:2]
    attn = L * 4.0 * D * tokens * (tokens + 1) / 2.0
    return (2.0 * tokens * L * layer_matmul_params(cfg)
            + 2.0 * head_matmul_params(cfg) + attn)


def fused_ffn_bytes(cfg: dict, rows: int = 1, weight_bytes: int = 2,
                    act_bytes: int = 2) -> float:
    """One fused-FFN call, relu(x @ w1 + b1) @ w2 + b2 on ``rows`` rows:
    each input and output once (x, w1, b1, w2, b2, out); per-column scales
    of fp8 weights in bf16."""
    _, D, Fd, _, _, _ = _dims(cfg)
    weights = 2 * D * Fd * weight_bytes
    scales = (Fd + D) * 2 if weight_bytes == 1 else 0
    return weights + scales + (Fd + D) * act_bytes + 2 * rows * D * act_bytes


def train_step_flops(cfg: dict, rows: int, sx: int, sy: int) -> float:
    """One training step over a padded batch [rows, sx + sy]: 6 FLOPs per
    weight and position (forward, and the backward's two products) in the
    decoder, the heads at the sy audio positions, and the causal
    attention's two products forward and backward; recompute not
    counted."""
    L, D = _dims(cfg)[:2]
    S = sx + sy
    attn = 3.0 * L * 4.0 * D * S * (S + 1) / 2.0
    return rows * (6.0 * S * L * layer_matmul_params(cfg)
                   + 6.0 * sy * head_matmul_params(cfg) + attn)
