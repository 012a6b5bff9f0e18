"""Model FLOPs and kernel bytes counted from shapes: the yardstick of every
``mfu.*`` and ``*_roofline.*`` metric.  Each count is the configuration's
architecture module's (``architectures/<architecture>.py``), which says what
it counts; a multiply-add is 2 FLOPs, and only useful work is counted."""

from __future__ import annotations

from .common import architecture


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies in one decoder layer."""
    return architecture(cfg).layer_matmul_params(cfg)


def head_matmul_params(cfg: dict) -> int:
    """Weights one position multiplies in the heads."""
    return architecture(cfg).head_matmul_params(cfg)


def decode_token_flops(cfg: dict, keys: int) -> float:
    """One decode step of one lane whose query sees ``keys`` positions
    (its own included)."""
    return architecture(cfg).decode_token_flops(cfg, keys)


def decode_span_flops(cfg: dict, first_keys: int, steps: int) -> float:
    """``steps`` consecutive decode steps of one lane, the first seeing
    ``first_keys`` positions: the sum of :func:`decode_token_flops`, which
    is linear in the keys, taken at their mean."""
    if steps <= 0:
        return 0.0
    return steps * decode_token_flops(cfg, first_keys + (steps - 1) / 2.0)


def prefill_flops(cfg: dict, tokens: int) -> float:
    """A causal prefill of ``tokens`` positions, heads at the last one."""
    return architecture(cfg).prefill_flops(cfg, tokens)


def fused_ffn_bytes(cfg: dict, rows: int = 1, weight_bytes: int = 2,
                    act_bytes: int = 2) -> float:
    """One fused-FFN call on ``rows`` rows: each input and output once."""
    return architecture(cfg).fused_ffn_bytes(cfg, rows, weight_bytes,
                                             act_bytes)


def train_step_flops(cfg: dict, rows: int, sx: int, sy: int) -> float:
    """One training step over a padded batch [rows, sx + sy]."""
    return architecture(cfg).train_step_flops(cfg, rows, sx, sy)
