"""control_ms_per_step: (the traced rollout's wall - its `fit` spans) /
its steps, ms: the rollout loop and the per-step controller."""


def read(s):
    return (s["wall_s"] - s["region_ns"] / 1e9) / s["steps"] * 1e3
