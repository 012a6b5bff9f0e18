"""The engine's counters: the wait for the bursts' snapshots over the
engine loop's host wall, over the window's bursts that ended before the
traced slice began."""
from harness.port_records import device_wait_share as read  # noqa: F401
