"""The BVH walks B1/B2's share of their roofline in one traced pass, in
percent: the sum over their launches of each launch's bound
(``walk_bounds``: the larger of 25 FP32 operations a box test and 54 a leaf
triangle test over 33.5 T op/s, and the rays' inputs and outputs and the BVH
tables moved once over 3.35 TB/s) over the sum of their device times.  The
box and leaf tests are the port's own counts, summed a launch under
``utils/profiling.counting()`` in the pass the driver records.  Nothing is
read where that pass launched no walk or the profiler's launches do not
match the recorded ones.  Layer: ops."""

from benchmarks.metrics import walk_bounds

# A traced run records one more pass's walk launches for this reader.
NEEDS = ("walks",)
# The launches' names in the counts and in the profiler.
KERNELS = {"bvh_closest": "bvh_closest_kernel", "bvh_any": "bvh_any_kernel"}


def read(rec):
    w = rec.get("walks")
    if not w or not w["calls"]:
        return None
    ops = w["trace"].in_window()
    total_bound = total_time = 0.0
    for name, kernel in KERNELS.items():
        calls = [c for c in w["calls"] if c["kernel"] == name]
        launched = sorted((o for o in ops if o.cat == "kernel" and kernel in o.name),
                          key=lambda o: o.start)
        if len(calls) != len(launched):
            return None
        for c, op in zip(calls, launched):
            total_bound += walk_bounds.launch_bound_s(c, w["table_bytes"])
            total_time += op.dur * 1e-6
    return 100.0 * total_bound / total_time if total_time > 0 else None
