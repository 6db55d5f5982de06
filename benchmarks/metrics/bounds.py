"""The roofline arithmetic, frozen for the benchmark (copied from
``chip_smoke.py`` when the benchmark was defined).

A launch's bound is the least time the card could take for it: the larger of
its FP32 operations over the unfused FP32 rate and its bytes over the memory
rate.  The port's kernels build with ``-fmad=false``, so every add and
multiply is its own instruction and the rate is half the 67 TFLOP/s that
counts a fused multiply-add as two.  Rates are the H100 SXM data sheet's, at
its full 700 W.
"""

from __future__ import annotations

PEAK_FP32_UNFUSED = 33.5e12    # FP32 operations/s
PEAK_BYTES = 3.35e12           # device memory bytes/s
# FP32 operations of one Moller-Trumbore test (csrc/mt_core.cuh mt_test):
# p 9, a 5, |a| test 2, f 2, s 3, u 6, q 9, v 6, t 6, acceptance 6.
MT_OPS = 54


def bound_s(ops: float, nbytes: float) -> float:
    """Seconds the card needs at least for ``ops`` operations and ``nbytes``
    bytes moved once."""
    return max(ops / PEAK_FP32_UNFUSED, nbytes / PEAK_BYTES)


def visit_bytes(B0: int, M: int, K: int, rows: int, trip_sum: int, n_visits: int,
                closest: bool, hit_tris: int) -> int:
    """Bytes one K4/K5 launch moves at least (``chip_smoke.visit_bound``):
    the rays (24 a lane), the lists' meta and cutoff (12 a row) and ids and
    nears up to each row's trip (8 an entry), the distinct cluster blocks
    (at most the visits, 10 x M floats each), and the outputs written once
    (closest: t, id, u, v and the 32-float attribute row, 144 a lane, and the
    hit triangles' attribute rows read once, 128 each; occlusion: tmax,
    exclusion and the flag, 9 a lane)."""
    R = rows * 128
    nbytes = R * 24 + B0 * 12 + trip_sum * 8 + min(K, n_visits) * 10 * M * 4
    if closest:
        return nbytes + hit_tris * 128 + R * 144
    return nbytes + R * 9
