"""launches_per_step: device kernels launched outside the `fit` spans,
per step: the per-step controller's launches."""


def read(s):
    return (s["kernels"] - s["kernels_in_region"]) / s["steps"]
