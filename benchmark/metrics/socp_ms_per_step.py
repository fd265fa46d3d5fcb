"""socp_ms_per_step: the stream time of the program's `step/socp` spans
(`solve_socp`: padding, warm start, kernel 3, residuals) / steps, ms."""
from benchmark.yardstick.spans import span_ms_per_step


def read(s):
    return span_ms_per_step(s, "step/socp")
