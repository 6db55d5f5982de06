"""The benchmark of ``chiaroscuro_tpu_torch`` on an NVIDIA H100 (``run.py``)."""
