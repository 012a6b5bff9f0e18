"""Device ms per decode step in the traced burst (operations summed)."""
from harness.readers import device_ms_per_step as read  # noqa: F401
