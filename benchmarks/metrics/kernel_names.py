"""Kernel names, frozen for the benchmark: which device kernels belong to
which part of the port (matched as substrings of the profiler's names)."""

from __future__ import annotations

# The port's intersection kernels (csrc/): K1/K2, K3 and K3b, K4-K7, B1/B2.
INTERSECTION = ("dense_kernel", "cull_rows_kernel", "cull_beam_kernel",
                "cull_beam_sweep_kernel", "closest_visits_kernel", "any_visits_kernel",
                "bvh_closest_kernel", "bvh_any_kernel")
# Every kernel of the port's own CUDA sources (csrc/*.cu).
PORT_CSRC = INTERSECTION + ("cull_rowhit_kernel", "dma_min_kernel")
# The cluster visits K4/K6 and K5/K7.
VISITS = ("closest_visits_kernel", "any_visits_kernel")
# Gathers, scatter-adds and one-hot products (ATen's indexing kernels and
# the matrix products of the one-hot fetches), by lower-cased substring.
FETCH = ("index", "gather", "scatter", "gemm", "cutlass", "xmma", "sm90_", "ampere_")


def is_nccl(name: str) -> bool:
    return name.lower().startswith("nccl")


def is_intersection(name: str) -> bool:
    return any(k in name for k in INTERSECTION)


def is_port_csrc(name: str) -> bool:
    return any(k in name for k in PORT_CSRC)


def is_fetch(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in FETCH) and not is_port_csrc(name)
