"""Device milliseconds a step of the port's intersection kernels; moves ``step_ms``.
Read by ``device_readers.isect_ms``."""

from benchmarks.metrics.device_readers import isect_ms as read  # noqa: F401
