"""Model FLOPs and kernel bytes counted from shapes: the yardstick of every
``mfu.*`` and ``*_roofline.*`` metric.  A multiply-add is 2 FLOPs.  Only
useful work is counted: attention over the keys a query may see, not over
a slab's padding; the heads where the program applies them (the last
prefill column and every decode step)."""

from __future__ import annotations


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


def decode_span_flops(cfg: dict, first_keys: int, steps: int) -> float:
    """``steps`` consecutive decode steps of one lane, the first seeing
    ``first_keys`` positions: the sum of :func:`decode_token_flops`."""
    if steps <= 0:
        return 0.0
    return steps * decode_token_flops(cfg, first_keys + (steps - 1) / 2.0)


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
