"""The traced window's peak device memory, in MiB; moves ``pass_ms.host`` (a frame whose pass the host sets).
Read by ``device_readers.peak_mib``."""

from benchmarks.metrics.device_readers import peak_mib as read  # noqa: F401
