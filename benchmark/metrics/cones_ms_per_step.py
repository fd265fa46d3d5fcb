"""cones_ms_per_step: the stream time of the program's `step/cones` spans
(the chance-constraint cones of the step's SOCPs) / steps, ms."""
from benchmark.yardstick.spans import span_ms_per_step


def read(s):
    return span_ms_per_step(s, "step/cones")
