"""Scalar helpers."""
from __future__ import annotations

import math


def normalize_radians(theta):
    """Wrap an angle to [-pi, pi) with a floor-mod, as the JAX package does."""
    return (theta + math.pi) % (2 * math.pi) - math.pi


def epsilon_interp(i, start=(0, 1.0), end=(1000, 0.01)) -> float:
    """Log-linear schedule between (step si, value sv) and (step ei, value
    ev), evaluated at a Python step index i (the exploration rate of
    `EpsilonGreedyController`)."""
    (si, sv), (ei, ev) = start, end
    return math.exp((i - si) / (ei - si) * (math.log(ev) - math.log(sv))
                    + math.log(sv))
