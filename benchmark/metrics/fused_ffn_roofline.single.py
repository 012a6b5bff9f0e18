"""The fused FFN's bytes bound at one decode row, bf16 weights, over its
mean time in the traced request."""
from harness.readers import fused_ffn_roofline_bf16 as read  # noqa: F401
