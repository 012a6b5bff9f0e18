"""The engine's counters: host ms in admission per refilled lane, over the
window's bursts that ended before the traced slice began."""
from harness.port_records import admit_ms_per_refill as read  # noqa: F401
