"""device_idle_pct: 1 - (union of device operations) / traced window, %
(the profiler stretches the host, so this reads high)."""


def read(s):
    if not s["window_ns"]:
        return None
    return 100.0 * (1.0 - s["busy_ns"] / s["window_ns"])
