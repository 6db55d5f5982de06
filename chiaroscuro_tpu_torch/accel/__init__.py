"""Intersector selection."""

from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors

__all__ = ["make_intersectors"]
