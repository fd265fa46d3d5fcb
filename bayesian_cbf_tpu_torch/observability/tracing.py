"""The port's spans and counters: one tracer, kept in memory.

A recording is open while `recording()` is entered or while a
`torch.profiler` session runs (`torch.autograd._profiler_enabled()`).
With none open, `span(name)` is one flag check that returns a shared
no-op context, and `count` evaluates nothing: a step dispatches no ATen
op and makes no CUDA call for them.  With one open, a span

  * enters `torch.profiler.record_function(name)`, so it lies on the
    profiler's host timeline beside the device operations it launches;
  * keeps its host start and end from `time.time_ns()`, the Unix-epoch
    clock kineto's `start_ns()` reads;
  * records a CUDA event on the current stream at its start and at its
    end, where CUDA is initialized: its `device_ns` is the stream's time
    between the two (the phase's device work when the card sets the
    pace, the host's enqueueing when the host does), None on the CPU;
  * nests: its path is the names of the spans open on its thread,
    outermost first ("step/cones").

`count(name, value, *args)` adds an int, a tensor's sum, or the sum of
`value(*args)` to a counter; tensors are summed and functions called at
`report()`, so a counter adds no operation to the step it counts in.
`report()` gives the most recent recording (the open or last-closed
`recording()`, or the last profiler session): each span path's calls,
host and device nanoseconds and their self parts (less the direct
children's), and each counter's total.  It resolves the pending CUDA
events and device counters once, with one synchronize, and gives the
same answer when called again.  Nothing is written anywhere else.

The spans and counters of the port:
  step, step/moments, step/lqr, step/cones, step/socp, fit (the runners
  and the per-step controllers); controller.episodes / .fallbacks (the
  feasibility gates); adam.episode_iters / .rejected (`mvgp.adam_fit`);
  launches.<wrapper> (the ten kernel wrappers in `ops/`);
  gramsolve.recompute (`ops/gramsolve`: CUDA backwards that recompute
  `km_expr` under autograd instead of the fit-Gram kernels);
  refresh.rung0..2 (`MVGP.refresh_cache`); psd_cholesky.rung<i>
  (`utils/linalg.psd_cholesky`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

_profiler_enabled = torch.autograd._profiler_enabled


class _Recording:
    def __init__(self):
        self.spans = []       # (path, host start, host end, event, event)
        self.tensors = []     # (counter name, tensor or function, args)
        self.counters = {}    # counter name -> int
        self.totals = {}      # path -> [n, host ns, device ns or None]


_open = 0                     # depth of the open `recording()` blocks
_rec = _Recording()           # what `report()` reads
_local = threading.local()
_NOOP = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a recording is open: compute a counter's value under it."""
    return _open > 0 or _profiler_enabled()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event():
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "path", "rf", "t0", "ev0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        stack.append(self.name)
        self.path = "/".join(stack)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev0 = _event()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        ev1 = _event()
        self.rf.__exit__(*exc)
        _stack().pop()
        _rec.spans.append((self.path, self.t0, t1, self.ev0, ev1))
        return False


def span(name: str):
    """A named region: a context manager, a no-op unless recording."""
    if _open or _profiler_enabled():
        return _Span(name)
    return _NOOP


def spanned(name: str):
    """Decorator: the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value=1, *args) -> None:
    """Add to the counter `name`, while recording: `value` an int; a
    tensor, whose sum is added; or a function, whose result's sum on
    `args` is added.  Tensors are summed and functions called at
    `report()`: pass the tensors a function reads as `args`, which keeps
    them as they are now."""
    if not (_open or _profiler_enabled()):
        return
    if isinstance(value, int):
        _rec.counters[name] = _rec.counters.get(name, 0) + value
    else:
        _rec.tensors.append((name, value, args))


def reset() -> None:
    """Forget what the current recording holds."""
    global _rec
    _rec = _Recording()


@contextlib.contextmanager
def recording():
    """Record the enclosed block's spans and counters into a fresh
    recording (an enclosing `recording()` keeps its own instead)."""
    global _open
    if not _open:
        reset()
    _open += 1
    try:
        yield
    finally:
        _open -= 1


def _resolve(rec: _Recording) -> None:
    """Fold the pending spans and tensor counters into the totals."""
    if not (rec.spans or rec.tensors):
        return
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    by_device = {}
    with torch.no_grad():
        for name, value, args in rec.tensors:
            t = (value(*args) if callable(value) else value).sum()
            by_device.setdefault(t.device, []).append((name, t))
    for items in by_device.values():
        vals = torch.stack([t.to(torch.int64) for _, t in items]).tolist()
        for (name, _), v in zip(items, vals):
            rec.counters[name] = rec.counters.get(name, 0) + v
    for path, t0, t1, ev0, ev1 in rec.spans:
        tot = rec.totals.setdefault(path, [0, 0, 0])
        tot[0] += 1
        tot[1] += t1 - t0
        if ev0 is None or ev1 is None or tot[2] is None:
            tot[2] = None
        else:
            tot[2] += round(ev0.elapsed_time(ev1) * 1e6)
    rec.spans, rec.tensors = [], []


def report() -> dict:
    """{"spans": {path: {"n", "host_ns", "device_ns", "self_host_ns",
    "self_device_ns"}}, "counters": {name: int}} of the most recent
    recording; device times are None where a span ran without CUDA."""
    rec = _rec
    _resolve(rec)
    spans = {}
    for path, (n, host, dev) in rec.totals.items():
        spans[path] = dict(n=n, host_ns=host, device_ns=dev,
                           self_host_ns=host, self_device_ns=dev)
    for path, (_, host, dev) in rec.totals.items():
        parent = spans.get(path.rpartition("/")[0])
        if parent is None:
            continue
        parent["self_host_ns"] -= host
        if parent["self_device_ns"] is not None:
            parent["self_device_ns"] = (None if dev is None
                                        else parent["self_device_ns"] - dev)
    return dict(spans=spans, counters=dict(rec.counters))


def _hook_profiler_start() -> None:
    """Start a fresh recording whenever a profiler session starts outside
    a `recording()`, so that `report()` gives the last session's.  Wraps
    `torch.autograd.profiler._run_on_profiler_start`, which every
    profiler session calls as it starts; where a torch has none, the
    profiler's spans add to the current recording."""
    prof = torch.autograd.profiler
    start = getattr(prof, "_run_on_profiler_start", None)
    if start is None or getattr(start, "tracing_hook", False):
        return

    def on_start():
        start()
        if not _open:
            reset()

    on_start.tracing_hook = True
    prof._run_on_profiler_start = on_start


_hook_profiler_start()
