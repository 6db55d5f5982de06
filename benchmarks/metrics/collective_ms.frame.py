"""Device milliseconds a pass of the all-gather's transfer: for each traced
pass, the least over the ranks of that pass's NCCL kernel time, averaged
over the passes.  Each rank's NCCL kernel runs from its own launch until the
last rank has arrived and the tiles have moved, so the rank that arrives
last waits for no one and its kernel time is the transfer; the others' add
the skew between the ranks.  Where a rank's NCCL kernels do not split into
the same whole number a pass, the least over the ranks of each rank's time a
pass is read instead (the transfer plus the least skew).  Nothing is read
where a rank launched none.  Layer: parallel."""

from benchmarks.metrics import kernel_names


def _nccl(t):
    return sorted((o for o in t.in_window() if o.cat == "kernel" and kernel_names.is_nccl(o.name)),
                  key=lambda o: o.start)


def _per_pass_ms(ks, units):
    if not ks or len(ks) % units:
        return None
    k = len(ks) // units
    return [sum(o.dur for o in ks[i * k:(i + 1) * k]) * 1e-3 for i in range(units)]


def read(rec):
    traces = rec.get("rank_traces")
    if not traces or not all(t.units for t in traces):
        return None
    kernels = [_nccl(t) for t in traces]
    if not all(kernels):
        return None
    per_pass = [_per_pass_ms(ks, t.units) for ks, t in zip(kernels, traces)]
    if all(p is not None for p in per_pass) and len({len(p) for p in per_pass}) == 1:
        return sum(min(p[i] for p in per_pass) for i in range(len(per_pass[0]))) / len(per_pass[0])
    return min(sum(o.dur for o in ks) * 1e-3 / t.units for ks, t in zip(kernels, traces))
