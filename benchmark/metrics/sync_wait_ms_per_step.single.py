"""The port's ``decode.sync`` spans' wall (the host waiting on each step
group's counts) over the decode steps of the traced request."""
from harness.port_records import sync_wait_ms_per_step as read  # noqa: F401
