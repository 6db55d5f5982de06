"""The roofline arithmetic of the BVH walks B1/B2, frozen for the benchmark
(``chip_smoke.py``'s per-lane ``walk_ops`` and ``bvh_bound``, with the whole
BVH tables counted as read).

A launch's bound is the larger of its FP32 operations over the unfused rate
(``bounds.bound_s``) and its bytes moved once over the memory rate.  Its
operations are BOX_OPS a box test (a step of a walk) and ``bounds.MT_OPS`` a
leaf triangle test, summed over its rays as the port counts them; its bytes
are its rays' inputs and outputs and the BVH's tables, each once.
"""

from __future__ import annotations

from benchmarks.metrics import bounds

# FP32 operations of one slab test (csrc/bvh_traverse.cu box_hit): per axis
# 2 sub, 2 mul, min, max (18); near and far across axes 4; the three
# compares 3.
BOX_OPS = 25
# Bytes a ray: origin and direction in (24); B1 hit, t, id, u, v out (17),
# B2 tmax and exclusion in (8) and the flag out (1).
RAY_BYTES = {"bvh_closest": 24 + 17, "bvh_any": 24 + 8 + 1}


def launch_bound_s(call: dict, table_bytes: int) -> float:
    """The bound of one recorded launch ``{"kernel", "rays", "steps",
    "tests"}`` over BVH tables of ``table_bytes``."""
    ops = BOX_OPS * int(call["steps"]) + bounds.MT_OPS * int(call["tests"])
    nbytes = RAY_BYTES[call["kernel"]] * int(call["rays"]) + int(table_bytes)
    return bounds.bound_s(ops, nbytes)
