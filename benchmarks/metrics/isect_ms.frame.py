"""Device milliseconds a pass of the port's intersection kernels; moves ``pass_ms``.
Read by ``device_readers.isect_ms``."""

from benchmarks.metrics.device_readers import isect_ms as read  # noqa: F401
