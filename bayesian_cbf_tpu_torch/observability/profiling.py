"""Tracing and profiling on `torch.profiler`.

  * `trace(logdir)`: a context manager that profiles the enclosed block
    (host operations, and the card's kernels where CUDA is available)
    and writes a Chrome trace to <logdir>/trace.json when it exits;
  * `annotate(name)`: a named region of that timeline, the tracer's
    `span` (`observability/tracing.py`; the runners mark their steps
    "step" and their refits "fit");
  * `elapsed_channel(logger, tag, seconds)`: an `<exp>/elapsed` scalar;
  * `decompose_trace(path)`: a trace's device time by kernel bucket and
    by span, its busy time and the gap the host leaves between kernels,
    in a region.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os

import torch

from . import tracing


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str, with_flops: bool = False):
    """Profile the enclosed block and write its Chrome trace to
    <logdir>/trace.json on exit.  Yields the trace's path; once the block
    has run, `trace.last` is its `torch.profiler.profile` (for
    `key_averages()`, and the flop counts with `with_flops`)."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with torch.profiler.profile(activities=_activities(),
                                with_flops=with_flops) as prof:
        yield path
    prof.export_chrome_trace(path)
    trace.last = prof


trace.last = None


annotate = tracing.span


def elapsed_channel(logger, tag: str, seconds: float, step: int = 0) -> None:
    """Log an `<exp>/elapsed` scalar (the reference's benchmark channel)."""
    logger.add_scalar(tag if tag.endswith("elapsed") else tag + "/elapsed",
                      seconds, step)


# ---------------------------------------------------------------------------
# offline decomposition of a trace
# ---------------------------------------------------------------------------

#: kernel-name substring -> bucket for `decompose_trace`, first match
#: wins: the port's kernels (csrc/*.cu); anything else is "other"
DEFAULT_BUCKETS = (
    ("kinv_logdet", "kinv_logdet"),
    ("chol_linv", "chol_linv"),
    ("ipm", "ipm"),
    ("fit_gram", "fit_gram"),
    ("gram", "gram"),
    ("sweep", "sweep"),
    ("cholsolve", "cholsolve"),
    ("solve_with_factor", "cholsolve"),
    ("chol_dinv", "chol_dinv"),
)


def load_trace_events(path: str):
    """The traceEvents of a Chrome trace (.json or .json.gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _union_s(intervals):
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def _launch_times(evs):
    """correlation id -> host timestamp of the launch that queued it."""
    out = {}
    for e in evs:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver"):
            out[corr] = e["ts"]
    return out


def kernel_events(evs):
    """The device kernels of a trace, each with `launch_ts`: the host
    time of its launch where the trace records it, else its own start."""
    launches = _launch_times(evs)
    out = []
    for e in evs:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            corr = (e.get("args") or {}).get("correlation")
            out.append(dict(e, launch_ts=launches.get(corr, e["ts"])))
    return out


def _regions(evs, name):
    return [e for e in evs if e.get("ph") == "X" and e.get("name") == name
            and e.get("cat") == "user_annotation"]


def _gaps(intervals, t0, t1):
    """The (start, end) stretches of [t0, t1] outside the union of the
    intervals."""
    out, cur = [], t0
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def _span_tree(evs, region):
    """(start, end, path) of the spans (user annotations) that lie inside
    the region event, the region first, sorted by start; a path is the
    names of the spans that hold the span, outermost first."""
    t0, t1 = region["ts"], region["ts"] + region["dur"]
    inner = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e is not region and t0 <= e["ts"]
                   and e["ts"] + e["dur"] <= t1)
    inner.sort(key=lambda s: (s[0], -s[1]))
    out = [(t0, t1, region["name"])]
    stack = [out[0]]
    for a, b, name in inner:
        while len(stack) > 1 and stack[-1][1] < b:
            stack.pop()
        stack.append((a, b, stack[-1][2] + "/" + name))
        out.append(stack[-1])
    return out


def _innermost(tree, times):
    """The path of the innermost span of `tree` (`_span_tree`) holding
    each of `times`; the region's own where none does."""
    out = [tree[0][2]] * len(times)
    stack, i = [], 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        x = times[j]
        while i < len(tree) and tree[i][0] <= x:
            while stack and stack[-1][1] < tree[i][0]:
                stack.pop()
            stack.append(tree[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        if stack:
            out[j] = stack[-1][2]
    return out


def decompose_trace(trace_path: str, buckets=DEFAULT_BUCKETS,
                    top_level: str = "steps") -> dict:
    """Device time of a `trace(...)` Chrome trace inside its region
    `top_level` (the longest `annotate(top_level)` region; ties: the
    latest), by kernel bucket and by span::

        {"span_s": ..., "leaf_busy_s": ..., "dispatch_gap_s": ...,
         "by_bucket": {bucket: seconds},
         "fit": {bucket: seconds}, "scan": {bucket: seconds},
         "by_span": {path: {"device_s", "idle_s", "launches"}}}

    The device events are the trace's kernels (cat "kernel"); a kernel
    belongs to the region when its launch lies inside it.  span_s runs
    from the region's start to its end or the last such kernel's end,
    whichever is later; leaf_busy_s is the time at least one of them
    runs, dispatch_gap_s the rest of the span: the device's idle share
    is dispatch_gap_s / span_s.  "fit" holds the kernels launched inside
    an `annotate("fit")` region, "scan" the others.  "by_span" puts each
    kernel under the innermost span (user annotation) inside the region
    that holds its launch, and each idle stretch of the span under the
    innermost one that holds its middle; a path names the spans that hold
    it from the region down ("steps/step/cones"), the region's own path
    takes what no inner span holds.  Raises ValueError when the trace has
    no such region."""
    evs = load_trace_events(trace_path)
    tops = _regions(evs, top_level)
    if not tops:
        raise ValueError("no %r region in %s" % (top_level, trace_path))
    dmax = max(e["dur"] for e in tops)
    span = [e for e in sorted(tops, key=lambda e: e["ts"])
            if e["dur"] == dmax][-1]
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    inside = [k for k in kernel_events(evs) if t0 <= k["launch_ts"] <= t1]
    fits = [(e["ts"], e["ts"] + e["dur"]) for e in _regions(evs, "fit")]

    def bucket_of(name):
        low = name.lower()
        for sub, b in buckets:
            if sub in low:
                return b
        return "other"

    by_bucket, fit, scan = {}, {}, {}
    for k in inside:
        sec = k.get("dur", 0) / 1e6
        b = bucket_of(k["name"])
        by_bucket[b] = by_bucket.get(b, 0.0) + sec
        tgt = fit if any(a <= k["launch_ts"] <= c for a, c in fits) else scan
        tgt[b] = tgt.get(b, 0.0) + sec
    end = max([t1] + [k["ts"] + k.get("dur", 0) for k in inside])
    span_s = (end - t0) / 1e6
    busy = _union_s([(k["ts"], k["ts"] + k.get("dur", 0)) for k in inside])
    order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    tree = _span_tree(evs, span)
    by_span = {}

    def row(path):
        return by_span.setdefault(path, {"device_s": 0.0, "idle_s": 0.0,
                                         "launches": 0})

    for k, path in zip(inside, _innermost(tree, [k["launch_ts"]
                                                 for k in inside])):
        row(path)["device_s"] += k.get("dur", 0) / 1e6
        row(path)["launches"] += 1
    idle = _gaps([(k["ts"], k["ts"] + k.get("dur", 0)) for k in inside],
                 t0, end)
    for (a, b), path in zip(idle, _innermost(tree, [(a + b) / 2
                                                    for a, b in idle])):
        row(path)["idle_s"] += (b - a) / 1e6
    return {"span_s": span_s, "leaf_busy_s": busy,
            "dispatch_gap_s": span_s - busy, "by_bucket": order(by_bucket),
            "fit": order(fit), "scan": order(scan), "by_span": by_span}


def kernel_summary(trace_path: str) -> dict:
    """{kernel name: {"device_ms": total, "launches": count}} over every
    kernel of a trace."""
    out = {}
    for k in kernel_events(load_trace_events(trace_path)):
        row = out.setdefault(k["name"], {"device_ms": 0.0, "launches": 0})
        row["device_ms"] += k.get("dur", 0) / 1e3
        row["launches"] += 1
    return out
