"""The traced rollout's summary, read from `torch.profiler`'s events in
memory (no Chrome trace is written).

The arithmetic is a frozen copy of `observability/profiling.py`'s
`_union_s`, `kernel_events` and `decompose_trace` (commit
1797f6cfa163b15fd5c129cc3ad66940ebf95206): a device operation belongs to
a region when the host call that launched it lies inside the region;
busy time is the union of the device operations' intervals, and the
rest of the window is idle.
"""
from __future__ import annotations

import bisect

# the host calls that queue device work, by name
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaLaunchCooperativeKernel")


def kind(e) -> str:
    """"kernel", "copy" (a device memcpy or memset), "launch" (the host
    call that queued one), "annotation" (a span on the host's timeline),
    "device annotation" (its copy on the device's) or "host" of a kineto
    event."""
    on_device = str(e.device_type()).endswith("CUDA")
    if e.is_user_annotation():
        return "device annotation" if on_device else "annotation"
    if on_device:
        return "copy" if e.name().startswith(("Memcpy", "Memset")) \
            else "kernel"
    if e.name() in LAUNCH_CALLS:
        return "launch"
    return "host"


def union_ns(intervals):
    """Nanoseconds covered by the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or b > end:
            total += b - (a if end is None else max(a, end))
            end = b
    return total


def gaps(intervals, t0, t1):
    """The idle (start, end) stretches of [t0, t1] outside the union of
    the intervals."""
    out, cur = [], t0
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def summarize(events, t0_ns: int, t1_ns: int, region: str = "fit",
              top: int = 10) -> dict:
    """The traced window [t0_ns, t1_ns] (host clock, ns) of profiler
    events (`prof.profiler.kineto_results.events()`):

    kernels, kernels_in_region: device kernels launched in the window /
        inside a `region` span (by the host time of their launch);
    region_ns: the summed length of the `region` spans;
    busy_ns / window_ns: the union of device operations in the window,
        and the window's length (from its start to its end or the last
        operation's end, whichever is later);
    by_kernel: {name: (launches, device ns)};
    device_ops, idle_gaps: the `top` device operations by time and the
        `top` host operations by the idle device time they leave."""
    launch_ts, dev, spans, host = {}, [], [], []
    for e in events:
        k = kind(e)
        if k == "launch":
            launch_ts[e.correlation_id()] = e.start_ns()
        elif k in ("kernel", "copy"):
            dev.append((k, e))
        elif k == "annotation" and e.name() == region:
            spans.append((e.start_ns(), e.end_ns()))
        elif k == "host" and t0_ns <= e.start_ns() <= t1_ns:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    spans.sort()
    span_starts = [a for a, _ in spans]

    def in_region(ts):
        i = bisect.bisect_right(span_starts, ts) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    inside, by_kernel = [], {}
    kernels = kernels_region = matched = 0
    for k, e in dev:
        ts = launch_ts.get(e.correlation_id())
        matched += ts is not None
        ts = e.start_ns() if ts is None else ts
        if not t0_ns <= ts <= t1_ns:
            continue
        a, b = e.start_ns(), e.end_ns()
        inside.append((a, b))
        if k == "kernel":
            kernels += 1
            kernels_region += in_region(ts)
        n, d = by_kernel.get(e.name(), (0, 0))
        by_kernel[e.name()] = (n + 1, d + (b - a))
    end = max([t1_ns] + [b for _, b in inside])
    busy = union_ns(inside)
    region_ns = sum(min(b, t1_ns) - max(a, t0_ns) for a, b in spans
                    if b > t0_ns and a < t1_ns)

    # each idle stretch charged to the innermost host operation running
    # at its middle
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for a, b in gaps(inside, t0_ns, end):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "(host, between operations)"
        for j in range(i, max(i - 200, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        if in_region(mid):
            label = f"{region}/{label}"
        idle[label] = idle.get(label, 0) + (b - a)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        kernels=kernels, kernels_in_region=kernels_region,
        launches_matched=matched, device_events=len(dev),
        region_ns=region_ns, busy_ns=busy, window_ns=end - t0_ns,
        by_kernel=by_kernel,
        device_ops=[[k, d / 1e9] for k, (_, d) in sorted(
            by_kernel.items(), key=lambda kv: -kv[1][1])[:top]],
        idle_gaps=[[k, v / 1e9] for k, v in rank(idle)])


def mean_kernel_s(s, subs):
    """Mean device seconds a launch of the kernels in summary `s` whose
    names hold one of `subs`, or None where none ran."""
    n = d = 0
    for name, (k, ns) in s["by_kernel"].items():
        if any(sub in name for sub in subs):
            n, d = n + k, d + ns
    return d / n / 1e9 if n else None
