"""Host spans around the port's calls, and the device trace of the window.

Spans come from the benchmark's own wrappers (traced runs only): each
wrapped call is a ``torch.profiler.record_function`` range and a host
clock pair, with the work its inputs need attached.  The profiler records
the window; ``reduce`` turns its events into device operations, each
attributed to the span its launch fell in.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from h100_bench.harness.work import Work

WINDOW = "h100_bench.window"  # the range around the whole traced window
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Span:
    __slots__ = ("name", "t0", "t1", "work")

    def __init__(self, name, t0, t1, work):
        self.name, self.t0, self.t1, self.work = name, t0, t1, work


class Spans:
    """Host spans of wrapped calls (one list, appended under a lock)."""

    def __init__(self):
        self.records: List[Span] = []
        self._lock = threading.Lock()
        self.on = False  # records only inside the window

    def wrap(self, name: str, fn: Callable, work_of: Optional[Callable] = None) -> Callable:
        """``fn`` inside a span; ``work_of(args, kwargs, out)`` -> the Work
        of the call's inputs (None: the span has no work)."""
        from torch.profiler import record_function

        def wrapped(*args, **kw):
            with record_function(name):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                t1 = time.perf_counter()
            if self.on:
                work = work_of(args, kw, out) if work_of else None
                with self._lock:
                    self.records.append(Span(name, t0, t1, work))
            return out

        return wrapped

    def of(self, name: str) -> List[Span]:
        return [s for s in self.records if s.name == name]

    def work(self, names=None) -> Work:
        total = Work()
        for s in self.records:
            if s.work is not None and (names is None or s.name in names):
                total.add(s.work)
        return total


class Trace:
    """Device operations of the traced window: ``ops`` (name, start, end,
    span name or None) in seconds from the window's start."""

    def __init__(self, ops, window_s: float, diagnostics: Dict):
        self.ops = ops
        self.window_s = window_s
        self.diagnostics = diagnostics

    def intervals(self):
        """The union of the device operations' intervals, clipped to the
        window: [start, end, span of the operation that opens it]."""
        merged = []
        for _, a, b, span in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, 0.0), min(b, self.window_s)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b, span])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b, _ in self.intervals())

    def span_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside ``name`` spans."""
        return sum(b - a for _, a, b, s in self.ops if s == name)

    def top_ops(self, n: int = 10):
        by = defaultdict(float)
        for name, a, b, _ in self.ops:
            by[name[:160]] += b - a
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The device's idle time summed by what the host was doing: the
        span the operation that ends each gap was launched from ("no span":
        outside every span; "window end": the gap before the close)."""
        by = defaultdict(float)
        prev = 0.0
        for a, b, span in self.intervals():
            if a > prev:
                by[span or "no span"] += a - prev
            prev = b
        if self.window_s > prev:
            by["window end"] += self.window_s - prev
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def reduce(events, spans: Optional[Spans], anchor: float, span_names) -> Optional[Trace]:
    """A Trace from the profiler's raw events (``prof.profiler.
    kineto_results.events()``), or None without the window's range.

    The profiler records host operations on the thread that started it
    only, but the card's operations and the CUDA calls that launched them
    (matched by correlation id) from every thread.  So each device
    operation is placed by its launch's start among the benchmark's own
    spans named ``span_names`` (host clocks, which ``anchor``, the host
    clock when the window's range opened, maps onto the profiler's)."""
    window = None
    device = []
    launch = {}  # correlation id of a CUDA call -> its start (ns)
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():  # kernels, copies, fills
                device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.correlation_id()))
        elif e.is_user_annotation():
            if e.name() == WINDOW:
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif e.name().startswith("cu"):  # the runtime and driver calls
            launch.setdefault(e.correlation_id(), e.start_ns())
    if window is None:
        return None
    w0 = window[0]
    host = sorted((w0 + (sp.t0 - anchor) * 1e9, w0 + (sp.t1 - anchor) * 1e9, sp.name)
                  for sp in (spans.records if spans is not None else ())
                  if sp.name in span_names)
    starts = [h[0] for h in host]

    def span_of(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return host[i][2] if i >= 0 and ts <= host[i][1] else None

    ops, launched = [], 0
    for name, a, b, corr in device:
        ts = launch.get(corr)
        launched += ts is not None
        ops.append((name, (a - w0) * 1e-9, (b - w0) * 1e-9,
                    span_of(ts) if ts is not None else None))
    diag = {"device_ops": len(device), "launched": launched,
            "in_spans": sum(1 for o in ops if o[3] is not None)}
    return Trace(ops, (window[1] - window[0]) * 1e-9, diag)


def profiler(trace: bool):
    """torch.profiler over host operations and the card (traced runs), or
    a context that does nothing."""
    if not trace:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def window_range(trace: bool):
    """The profiler range that marks the traced window."""
    if not trace:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(WINDOW)


def reduce_profile(prof, spans: Optional[Spans], anchor: float, span_names) -> Optional[Trace]:
    """The Trace of a finished profiler (None: not traced)."""
    if prof is None:
        return None
    return reduce(prof.profiler.kineto_results.events(), spans, anchor, span_names)
