"""The engine's counters: 90th percentile of admission to the first
streamed rows that complete a frame, over the window's requests retired
before the traced slice began."""
from harness.port_records import first_rows_p90_ms as read  # noqa: F401
