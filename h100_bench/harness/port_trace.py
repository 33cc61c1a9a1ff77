"""The port's own spans and counters on the device trace.

``haconvdr_torch.utils.telemetry.TRACER`` records spans inside the serving
path (``request.*``, ``batcher.*``, ``tower.*``, ``search.*``) on every
thread, stamped with ``perf_counter_ns``; its ``Snapshot`` carries the
clock pair that places them on the profiler's clock, and the deltas of
the kernels' counters over the window.  A run that hands the snapshot to
its reading (``PortReading.port``) and keeps the window's start on the
profiler's clock (``reduce_profile`` here) gives:

* ``idle_by_port``: the device's idle time split by what the batcher's
  worker was doing at each instant (its innermost span; ``worker.outside``
  in none), where ``Trace.idle_gaps`` names each gap after the benchmark
  span of the operation that closes it;
* the per-dispatch means and the queue's percentile the readers in
  ``metrics/`` report;
* ``launches``: the window's CUDA launch calls, and those that fall in
  none of the worker's launching spans (a check of the clock pair).

``port_split.py`` is the run that does so; the drivers do not start the
tracer yet.  Every function here returns None where the reading holds no
snapshot (a run of a program without the tracer), and leaves ``Trace``
and the readers that were there unchanged.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from h100_bench.harness import trace as T
from h100_bench.harness.readers import Reading

OUTSIDE = "worker.outside"  # the worker in none of its spans
END = "window end"  # after the window's last device operation
DISPATCH = "batcher.dispatch"
WAIT = ("batcher.wait",)  # the worker waiting for requests: demand, not the port's cost
# the worker's host work: a dispatch's own code (padding, the ids' mapping),
# collation, copies in, launches, the answers, and its code outside any span
HOST = (DISPATCH, "tower.collate", "tower.h2d", "tower.launch", "search.launch",
        "batcher.resolve", OUTSIDE)
# the worker's spans that call into CUDA
LAUNCHING = ("tower.h2d", "tower.launch", "tower.wait", "search.launch", "search.wait")


@dataclasses.dataclass
class PortReading(Reading):
    port: Optional[Any] = None  # the TRACER snapshot of the window


def snapshot_of(r) -> Optional[Any]:
    return getattr(r, "port", None)


def reduce_profile(prof, spans, anchor: float, span_names) -> Optional[T.Trace]:
    """``trace.reduce_profile``'s Trace, with ``window_start_ns``: the
    window's start on the profiler's clock."""
    if prof is None:
        return None
    events = list(prof.profiler.kineto_results.events())
    tr = T.reduce(events, spans, anchor, span_names)
    if tr is not None:  # reduce found the window
        tr.window_start_ns = _window(events)[0]
    return tr


def _window(events) -> Optional[Tuple[int, int]]:
    """The traced window's range on the profiler's clock (ns)."""
    for e in events:
        if e.is_user_annotation() and e.name() == T.WINDOW:
            return e.start_ns(), e.start_ns() + e.duration_ns()
    return None


def launches(events, snap) -> Optional[Dict[str, int]]:
    """The window's CUDA launch calls (``cu*Launch*``, from every thread)
    and how many start in none of the worker's ``LAUNCHING`` spans placed
    by the snapshot's clock pair: 0 where the pair holds."""
    window = _window(events)
    tid = worker_thread(snap) if snap is not None else None
    if window is None or tid is None:
        return None
    iv = sorted((snap.profiler_ns(s.t0), snap.profiler_ns(s.t1)) for s in snap.spans
                if s.tid == tid and s.name in LAUNCHING)
    starts = [a for a, _ in iv]
    n = outside = 0
    for e in events:
        name = e.name()
        if (str(e.device_type()).endswith("CUDA") or e.is_user_annotation()
                or not name.startswith("cu") or "Launch" not in name):
            continue
        ts = e.start_ns()
        if window[0] <= ts <= window[1]:
            n += 1
            i = bisect.bisect_right(starts, ts) - 1
            outside += not (i >= 0 and ts <= iv[i][1])
    return {"launches": n, "outside": outside}


def worker_thread(snap) -> Optional[int]:
    """The thread that ran most dispatches (the batcher's worker)."""
    by = defaultdict(int)
    for s in snap.of(DISPATCH):
        by[s.tid] += 1
    return max(by, key=by.get) if by else None


def worker_segments(snap, tid: int, w0_ns: int) -> List[Tuple[float, float, str]]:
    """The worker's timeline as (start, end, innermost span) in seconds
    from the window's start: its spans nest, so at each instant the
    innermost is the open one that began last."""
    spans = sorted((((snap.profiler_ns(s.t0) - w0_ns) * 1e-9,
                     (snap.profiler_ns(s.t1) - w0_ns) * 1e-9, s.name)
                    for s in snap.spans if s.tid == tid), key=lambda s: (s[0], -s[1]))
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []  # (end, name) of the open spans
    t = float("-inf")

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if end > t:
                segs.append((t, end, name))
                t = end

    for a, b, name in spans:
        close_until(a)
        if stack and a > t:
            segs.append((t, a, stack[-1][1]))
        t = max(t, a)
        stack.append((b, name))
    close_until(float("inf"))
    return segs


def idle_by_port(trace, snap) -> Optional[List[List]]:
    """The device's idle time in the window summed by the worker's
    innermost span at each instant ([name, seconds], largest first): the
    idle before the last device operation is split by time overlap with
    the worker's timeline (``worker.outside`` where it is in no span);
    the idle after it is ``window end``.  The parts sum to the window
    less ``trace.busy_s()``."""
    w0 = getattr(trace, "window_start_ns", None)
    if trace is None or snap is None or w0 is None:
        return None
    tid = worker_thread(snap)
    if tid is None:
        return None
    segs = worker_segments(snap, tid, w0)
    by: Dict[str, float] = defaultdict(float)
    prev = 0.0
    i = 0
    for a, b, _ in trace.intervals():
        if a > prev:
            i = _split(prev, a, segs, i, by)
        prev = b
    if trace.window_s > prev:
        by[END] += trace.window_s - prev
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])


def _split(a: float, b: float, segs, i: int, by: Dict[str, float]) -> int:
    """Add the idle [a, b] to ``by`` by segment; returns the first segment
    that may reach past b (the idle intervals come in order)."""
    while i < len(segs) and segs[i][1] <= a:
        i += 1
    covered = 0.0
    j = i
    while j < len(segs) and segs[j][0] < b:
        s0, s1, name = segs[j]
        part = min(b, s1) - max(a, s0)
        if part > 0:
            by[name] += part
            covered += part
        j += 1
    by[OUTSIDE] += (b - a) - covered
    return i


def dispatches(snap) -> int:
    """The window's dispatches: its ``batcher.dispatch`` spans."""
    return sum(1 for s in snap.spans if s.name == DISPATCH)


def per_dispatch_ms(r, name: str) -> Optional[float]:
    """Host ms of ``name`` spans inside dispatches, over the dispatches."""
    snap = snapshot_of(r)
    n = dispatches(snap) if snap is not None else 0
    if not n:
        return None
    total = sum(s.t1 - s.t0 for s in snap.of(name) if "dispatch" in s.ids)
    return total * 1e-6 / n


def queue_wait_p95_ms(r) -> Optional[float]:
    snap = snapshot_of(r)
    waits = [(s.t1 - s.t0) * 1e-6 for s in snap.of("request.queue")] if snap else []
    return float(np.percentile(waits, 95)) if waits else None


def idle_per_dispatch_ms(r, names: Iterable[str]) -> Optional[float]:
    """Device idle ms while the worker was in ``names``, over the dispatches."""
    snap = snapshot_of(r)
    split = idle_by_port(r.trace, snap)
    n = dispatches(snap) if split is not None else 0
    if not n:
        return None
    names = set(names)
    return sum(v for k, v in split if k in names) * 1e3 / n


def plain_counts(counters: Dict[str, Dict[str, int]]) -> int:
    """The ``plain*`` entries of the kernels' counters, summed."""
    return sum(v for group, counts in counters.items() if group.startswith("ops.")
               for k, v in counts.items() if k.startswith("plain"))
