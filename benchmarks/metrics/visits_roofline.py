"""The cluster visits K4/K5's share of their roofline in one traced pass, in
percent: the sum over their launches of each launch's bound (``bounds``:
the larger of 54 FP32 operations a ray-triangle test over 33.5 T op/s and
the bytes moved once over 3.35 TB/s) over the sum of their device times.
Tests are counted per lane (``visit_replay.lane_walk``): each lane's tests
on its own K3 list up to its own exit, on the wavefronts the pass recorded.
Nothing is read where the pass launched no visit kernel or the profiler's
launches do not match the recorded ones.  Layer: ops."""

import torch

from benchmarks.metrics import kernel_names, visit_replay

# A traced run records one more pass's visit launches for this reader.
NEEDS = ("visits",)


def read(rec):
    v = rec.get("visits")
    if not v or not v["calls"]:
        return None
    kern = {k: sorted((o for o in v["trace"].in_window()
                       if o.cat == "kernel" and k in o.name), key=lambda o: o.start)
            for k in kernel_names.VISITS}
    calls = {"closest_visits_kernel": [c for c in v["calls"] if c["closest"]],
             "any_visits_kernel": [c for c in v["calls"] if not c["closest"]]}
    total_bound = total_time = 0.0
    for k, cs in calls.items():
        if len(cs) != len(kern[k]):
            return None
        for c, op in zip(cs, kern[k]):
            total_bound += visit_replay.launch_bound_s(c)
            total_time += op.dur * 1e-6
    torch.cuda.empty_cache()
    return 100.0 * total_bound / total_time if total_time > 0 else None
