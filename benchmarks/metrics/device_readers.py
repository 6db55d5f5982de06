"""Readers that several metrics share, one function a quantity.  A metric's
own file (``<quantity>.<moves>.py``) names which end-to-end metric it moves
and takes its ``read`` from here."""

from benchmarks.metrics import kernel_names


def idle_pct(rec):
    """Share of the traced window with no operation on the card: 100 minus
    the union of the device operations' intervals (kernels, copies, sets)
    over the window, in percent.  Layer: device."""
    t = rec.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_mib(rec):
    """Peak device memory of the traced window: ``torch.cuda.max_memory_allocated``
    after ``reset_peak_memory_stats`` at the window's start, in MiB.  Layer:
    device."""
    b = rec.get("window_peak_bytes")
    return None if not b else b / 2.0 ** 20


def isect_ms(rec):
    """Device milliseconds a pass or a step of the port's intersection
    kernels (K1/K2, K3/K3b, K4-K7, B1/B2 by name) in the traced window.
    Layer: ops."""
    t = rec.get("trace")
    return None if t is None else t.per_unit_ms(lambda o: kernel_names.is_intersection(o.name))


def integrator_ms(rec):
    """Device milliseconds a pass of every kernel that is neither one of the
    port's own CUDA kernels (csrc/) nor NCCL's: the integrator's operators,
    the sample streams, sorts, gathers and copies.  Layer: render."""
    t = rec.get("trace")
    if t is None:
        return None
    return t.per_unit_ms(lambda o: not kernel_names.is_port_csrc(o.name)
                         and not kernel_names.is_nccl(o.name))
