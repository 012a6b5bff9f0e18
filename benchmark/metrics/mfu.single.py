"""Model FLOPs of the window's untraced requests over their wall time, as a
share of the bf16 peak."""
from harness.readers import mfu as read  # noqa: F401
