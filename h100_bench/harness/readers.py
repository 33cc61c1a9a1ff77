"""What the per-layer readers (``metrics/<name>.py``) share.  A reader
takes the run's ``Reading`` and returns a number, or None where it finds
nothing to read (the metric is then left out of the line)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from h100_bench.harness.trace import Spans, Trace


@dataclasses.dataclass
class Reading:
    spans: Optional[Spans]
    trace: Optional[Trace]
    counters: Dict


def span_mean_s(r: Reading, name: str) -> Optional[float]:
    """Mean host seconds of ``name`` spans a call."""
    if r.spans is None:
        return None
    d = [s.t1 - s.t0 for s in r.spans.of(name)]
    return float(np.mean(d)) if d else None


def roofline_pct(r: Reading, name: str) -> Optional[float]:
    """The least time of the work of ``name`` spans over the device time
    of the operations launched inside them, in %."""
    if r.trace is None or r.spans is None:
        return None
    dev = r.trace.span_device_s(name)
    work = r.spans.work([name])
    if dev <= 0 or not work.ops:
        return None
    return 100.0 * work.least_seconds() / dev


def idle_pct(r: Reading) -> Optional[float]:
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)


def mfu_pct(r: Reading) -> Optional[float]:
    """The least time of all the window's work over the window's wall."""
    if r.trace is None or r.spans is None or r.trace.window_s <= 0 or not r.trace.ops:
        return None
    work = r.spans.work()
    if not work.ops:
        return None
    return 100.0 * work.least_seconds() / r.trace.window_s
