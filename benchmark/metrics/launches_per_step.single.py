"""Device operations per decode step in the traced request."""
from harness.readers import ops_per_step as read  # noqa: F401
