"""Seconds of the port's intersector set-up: ``Renderer.phase_seconds
["intersectors"]`` where a renderer runs, else the harness's synchronised
clock around the clusters and ``make_intersectors``.  Layer: accel.  Moves
``setup_s``."""


def read(rec):
    return rec.get("accel_s")
