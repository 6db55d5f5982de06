"""Per-layer metric readers (``<metric>.py``, one a metric) and the frozen
arithmetic they share."""
