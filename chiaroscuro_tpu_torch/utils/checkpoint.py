"""Checkpoint/resume for progressive rendering (a copy of
``chiaroscuro_tpu/utils/checkpoint.py``, numpy only, so the two packages
read and write the same files).

The reference keeps progressive accumulation only in memory (static locals in
``rayTrace``, ``src/rayTracer.cpp:18-33``) — closing the app loses all
samples.  Here accumulation state (sum image + layer count + camera + seed) is
an explicit, serializable object, so long renders can be checkpointed and
resumed across process restarts or multi-host failures (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class AccumulationState:
    """Running sum of per-layer mean images plus metadata."""

    pixel_sum: np.ndarray          # (H, W, 3) float64 sum of layer means
    layers: int                    # number of accumulated layers
    samples_per_layer: int
    camera: Tuple                  # (eye, center, up, yview) tuples
    seed: int

    @property
    def pixels(self) -> np.ndarray:
        """Current mean image."""
        if self.layers == 0:
            return np.zeros_like(self.pixel_sum, dtype=np.float32)
        return (self.pixel_sum / self.layers).astype(np.float32)

    @property
    def total_samples(self) -> int:
        return self.layers * self.samples_per_layer

    def add_layer(self, layer_mean: np.ndarray) -> None:
        self.pixel_sum = self.pixel_sum + np.asarray(layer_mean, np.float64)
        self.layers += 1

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        meta = dict(
            layers=self.layers,
            samples_per_layer=self.samples_per_layer,
            camera=[list(map(float, np.ravel(c))) for c in self.camera[:3]]
            + [float(self.camera[3])],
            seed=self.seed,
        )
        np.savez_compressed(
            path, pixel_sum=self.pixel_sum, meta=json.dumps(meta)
        )

    @classmethod
    def load(cls, path: str) -> "AccumulationState":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cam = meta["camera"]
            return cls(
                pixel_sum=z["pixel_sum"],
                layers=int(meta["layers"]),
                samples_per_layer=int(meta["samples_per_layer"]),
                camera=(
                    tuple(cam[0]),
                    tuple(cam[1]),
                    tuple(cam[2]),
                    float(cam[3]),
                ),
                seed=int(meta["seed"]),
            )

    @classmethod
    def fresh(
        cls, yres: int, xres: int, samples_per_layer: int, camera, seed: int
    ) -> "AccumulationState":
        return cls(
            pixel_sum=np.zeros((yres, xres, 3), np.float64),
            layers=0,
            samples_per_layer=samples_per_layer,
            camera=camera,
            seed=seed,
        )

    def matches_camera(self, camera, atol: float = 0.0) -> bool:
        for a, b in zip(self.camera, camera):
            if not np.allclose(np.asarray(a), np.asarray(b), atol=atol):
                return False
        return True


def resume_or_fresh(
    path: Optional[str], yres, xres, samples_per_layer, camera, seed
) -> AccumulationState:
    """Load state from ``path`` when compatible, else start fresh — the
    reference's moved-camera reset (``rayTracer.cpp:27-33``), made durable."""
    if path and os.path.exists(path):
        state = AccumulationState.load(path)
        if (
            state.pixel_sum.shape == (yres, xres, 3)
            and state.samples_per_layer == samples_per_layer
            and state.seed == seed
            and state.matches_camera(camera)
        ):
            return state
    return AccumulationState.fresh(yres, xres, samples_per_layer, camera, seed)
