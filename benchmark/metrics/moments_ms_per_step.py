"""moments_ms_per_step: the stream time of the program's `step/moments`
spans (the posterior moments, or their derivatives) / steps, ms."""
from benchmark.yardstick.spans import span_ms_per_step


def read(s):
    return span_ms_per_step(s, "step/moments")
