"""Mean wall of the port's ``decode.step`` spans in the traced request: the
host issuing one decode step under the profiler."""
from harness.port_records import step_host_ms as read  # noqa: F401
