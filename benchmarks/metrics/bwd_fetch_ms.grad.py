"""Device milliseconds a step of the backward's gathers, scatter-adds and
one-hot products: kernels launched from the backward's thread whose names
hold one of ``kernel_names.FETCH`` (ATen's index, gather and scatter
kernels; the matrix products of the one-hot fetches).  Layer: autograd."""

from benchmarks.metrics import kernel_names


def read(rec):
    t = rec.get("trace")
    if t is None:
        return None
    return t.per_unit_ms(lambda o: o.backward and kernel_names.is_fetch(o.name))
