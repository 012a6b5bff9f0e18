"""The traced request's prefill: from the port's ``decode.prefill`` span's
start to the end of the prefill's last device operation."""
from harness.port_records import prefill_ms as read  # noqa: F401
