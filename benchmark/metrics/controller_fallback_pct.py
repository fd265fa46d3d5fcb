"""controller_fallback_pct: episode-steps whose solve failed the
feasibility gate and took the fallback control, over those gated, %
(the program's `controller.fallbacks` / `controller.episodes`)."""
from benchmark.yardstick.spans import counter_pct


def read(s):
    return counter_pct("controller.fallbacks", "controller.episodes")
