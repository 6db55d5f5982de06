"""The traced window's share with no operation on the card, in percent; moves ``step_ms``.
Read by ``device_readers.idle_pct``."""

from benchmarks.metrics.device_readers import idle_pct as read  # noqa: F401
