"""Model FLOPs of the window's untraced steps from their batches' shapes
(6 per weight and position, the heads, the causal attention forward and
backward; recompute not counted) over their wall time, as a share of the
bf16 peak."""
from harness.readers import mfu as read  # noqa: F401
