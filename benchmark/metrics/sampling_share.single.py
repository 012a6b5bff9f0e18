"""The port's ``decode.sample`` spans' share of its ``decode.step`` spans'
wall in the traced request."""
from harness.port_records import sampling_share as read  # noqa: F401
