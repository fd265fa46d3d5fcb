"""Chance-constraint safety factors."""
from __future__ import annotations

import math

import torch


def cbc1_safety_factor(delta: float) -> float:
    """Gaussian bound sqrt(2) erfinv(1 - 2 delta), for delta < 0.5."""
    if not delta < 0.5:
        raise ValueError("require more than 50% safety (delta < 0.5)")
    e = torch.special.erfinv(torch.tensor(1.0 - 2.0 * delta,
                                          dtype=torch.float64))
    return math.sqrt(2.0) * float(e)
