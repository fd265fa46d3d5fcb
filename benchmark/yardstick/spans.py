"""The program's own spans and counters (`bayesian_cbf_tpu_torch.
observability.tracing`): a recording is open while a `torch.profiler`
session runs, so the traced rollout's session is the program's most
recent recording when the per-layer readers run.  Each helper returns
None where the program has no tracer (an earlier commit) or recorded no
such span or counter."""
from __future__ import annotations


def report():
    """The program's `tracing.report()`, or None without a tracer."""
    try:
        from bayesian_cbf_tpu_torch.observability import tracing
    except ImportError:
        return None
    return tracing.report()


def span_ms_per_step(s, path: str, key: str = "device_ns"):
    """The span `path`'s `key` (device_ns: its stream time; host_ns: the
    host's) over the traced rollout's steps (summary `s`), ms."""
    rep = report()
    row = None if rep is None else rep["spans"].get(path)
    if row is None or row[key] is None:
        return None
    return row[key] / 1e6 / s["steps"]


def counter_pct(part: str, whole: str):
    """100 x counter `part` / counter `whole`; None where `whole` was not
    counted."""
    rep = report()
    if rep is None or not rep["counters"].get(whole):
        return None
    return 100.0 * rep["counters"].get(part, 0) / rep["counters"][whole]
