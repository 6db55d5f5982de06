"""The port's counterparts of the repo's ``tools/`` scripts that hold a TPU
kernel, each runnable on the card with ``python -m``:

- ``cull_experiments``: ``tools/tpu_cull_experiments.py``, the cull
  formulation shootout, with X1 (its Pallas row-hit cull) in CUDA
  (``csrc/cull_rowhit.cu``).
- ``dma_min``: ``tools/_tpu_dma_min.py``, the double-buffered block fetch
  X2 in CUDA (``csrc/dma_min.cu``).
"""
