"""Device milliseconds a pass of the integrator's kernels (neither
the port's csrc nor NCCL's); moves ``pass_ms``.
Read by ``device_readers.integrator_ms``."""

from benchmarks.metrics.device_readers import integrator_ms as read  # noqa: F401
