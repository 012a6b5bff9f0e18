"""The traced step's ScaledAdam update: from the port's ``train.update``
span's start to the end of the step's last device operation."""
from harness.port_records import optimizer_ms as read  # noqa: F401
