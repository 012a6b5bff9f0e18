"""Device ms of the traced training step (operations summed)."""
from harness.readers import device_ms_per_step as read  # noqa: F401
