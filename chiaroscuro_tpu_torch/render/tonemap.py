"""exrdisplay-style knee/gamma tone map for 8-bit export and preview.

Reimplements the reference's ``normalizeImage`` (``src/rayTracer.cpp:173-223``,
itself following OpenEXR's exrdisplay):

    m  = 2^(exposure + 2.47393)
    s  = 255 * 2^(-3.5 * gamma)
    kl = 2^kneeLow
    f  = solve knee(2^kneeHigh, f) = 2^3.5 - kl  (bisection, 30 iters)
    t(x) = clamp( (kl + knee(max(0, x - defog) * m - kl, f))^gamma * s, 0, 255 )
           when x*m > kl, else (x*m)^gamma * s

Defaults match ``include/rayTracer.hpp:22-23``: defog=0, kneeLow=0,
kneeHigh=5, gamma=2.2.
"""

from __future__ import annotations

import math

import numpy as np


def _knee(x: float, f: float) -> float:
    return math.log(x * f + 1.0) / f


def find_knee_f(x: float, y: float) -> float:
    """Bisection solve for f with knee(x, f) = y (``rayTracer.cpp:175-195``)."""
    f0, f1 = 0.0, 1.0
    while _knee(x, f1) > y:
        f0 = f1
        f1 = f1 * 2.0
    for _ in range(30):
        f2 = (f0 + f1) / 2.0
        if _knee(x, f2) < y:
            f1 = f2
        else:
            f0 = f2
    return (f0 + f1) / 2.0


def normalize_image(
    pixels: np.ndarray,
    exposure: float,
    defog: float = 0.0,
    knee_low: float = 0.0,
    knee_high: float = 5.0,
    gamma: float = 2.2,
) -> np.ndarray:
    """HDR (H, W, 3) float -> uint8 (H, W, 3), exrdisplay transform."""
    pixels = np.asarray(pixels, dtype=np.float32)
    m = np.float32(2.0 ** (exposure + 2.47393))
    s = np.float32(255.0 * 2.0 ** (-3.5 * gamma))
    kl = np.float32(2.0**knee_low)
    f = np.float32(find_knee_f(2.0**knee_high, 2.0**3.5 - kl))

    x = np.maximum(0.0, pixels - np.float32(defog)) * m
    x = np.where(x > kl, kl + np.log(np.maximum(x - kl, 0.0) * f + 1.0) / f, x)
    out = np.clip(np.power(x, np.float32(gamma)) * s, 0.0, 255.0)
    return out.astype(np.uint8)
