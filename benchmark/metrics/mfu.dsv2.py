"""Model FLOPs of every request due in the window (its refill prefill and
its decode steps, active parameters only) over the time from the window's
start until the last of them finished, as a share of the bf16 peak."""
from harness.readers import mfu as read  # noqa: F401
