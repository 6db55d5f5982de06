"""Seconds of the port's ``build_scene_tensors`` on the frozen inputs, up to
a synchronise (the harness's clock).  Layer: scene.  Moves ``setup_s``."""


def read(rec):
    return rec.get("scene_s")
