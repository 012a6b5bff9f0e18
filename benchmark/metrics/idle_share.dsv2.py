"""Share of the traced burst's wall time with no device operation running."""
from harness.readers import idle_share as read  # noqa: F401
