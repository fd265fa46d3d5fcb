"""lqr_ms_per_step: the stream time of the program's `step/lqr` spans (the
pendulum's LQR reference on the learned linearization) / steps, ms."""
from benchmark.yardstick.spans import span_ms_per_step


def read(s):
    return span_ms_per_step(s, "step/lqr")
