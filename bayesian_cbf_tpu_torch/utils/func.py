"""Scalar helpers."""
from __future__ import annotations

import math


def normalize_radians(theta):
    """Wrap an angle to [-pi, pi) with a floor-mod, as the JAX package does."""
    return (theta + math.pi) % (2 * math.pi) - math.pi
