"""step_host_ms_per_step: the host time of the program's `step` spans /
steps, ms: what the host spends enqueueing a step.  Above the phases'
summed stream times, the host sets the step's pace."""
from benchmark.yardstick.spans import span_ms_per_step


def read(s):
    return span_ms_per_step(s, "step", key="host_ns")
