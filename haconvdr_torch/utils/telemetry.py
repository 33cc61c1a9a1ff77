"""Lightweight run telemetry (counterpart of haconvdr_tpu/utils/telemetry.py).

The reference's observability is stdlib logging of step losses every
print_steps (src/train_HAConvDR_topiocqa.py:191-197) and per-block search
latency dicts (src/test_HAConvDR_topiocqa.py:101-108).  Here a subsystem
can also emit structured events to a JSONL file (greppable, plottable):
``Trainer(metrics=MetricsLogger(path))`` logs one ``train_step`` event
(epoch, micro step, loss) per micro step.

``TRACER`` holds the serving path's spans and counters (the port's own,
not a benchmark's wrappers).  Off, ``TRACER.span`` hands back one shared
context that does nothing and no clock is read.  On (``start()`` ..
``stop()``), each span keeps its name, ``perf_counter_ns`` start and end,
thread, enclosing span on that thread and ids (``request=``,
``dispatch=``, ``requests=``) in memory; ``stop()`` returns a
:class:`Snapshot` with the spans, a clock pair that places them on the
profiler's clock, and the deltas of every ``ops.*.COUNTS`` dict (a
dispatch's and a request's count are their spans').  Spans are named
``<layer>.<phase>``:

  request.build     BatchingRetriever.submit's query building (request)
  request.queue     enqueue to the moment the request's batch closes
                    (request, dispatch; no thread: it spans two)
  batcher.wait      the worker waiting for the batch's requests (dispatch)
  batcher.dispatch  one dispatch (dispatch, requests); the rows below
                    are its children and take its dispatch id
  tower.collate     the batch iterator's next() in encode_batches, where
                    a lazy iterator collates
  tower.h2d         the ids and mask copied to the device
  tower.launch      the tower's launches, returning before any sync
  tower.route       inside tower.launch, an expert layer's router logits
                    and the launch of its routing kernel (ops.moe)
  tower.experts     inside tower.launch, the launches of an expert layer's
                    grouped expert products (ops.moe)
  tower.wait        the embeddings copied back (the host sync)
  search.launch     the queries copied and the search launched
  search.wait       the scores and ids copied back (the host sync)
  batcher.resolve   the answers built and the futures resolved
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class MetricsLogger:
    """Append-only JSONL event sink.  No-op when path is empty."""

    def __init__(self, path: str = "", flush_every: int = 20):
        self.path = path
        self._f = None
        self._n = 0
        self.flush_every = flush_every
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        if self._f is None:
            return
        rec: Dict[str, Any] = {"t": round(time.time() - self._t0, 3), "event": event}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


# one finished span: perf_counter_ns ends, the thread that ran it (None:
# an interval across threads), the id of its enclosing span (None: none)
SpanRecord = collections.namedtuple("SpanRecord", "sid name t0 t1 tid parent ids")


class _NullSpan:
    """The span handed out while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "ids", "t0", "sid", "parent", "tid")

    def __init__(self, tracer: "Tracer", name: str, t0: Optional[int], ids: Dict):
        self.tracer, self.name, self.t0, self.ids = tracer, name, t0, ids

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        if self.parent is not None and "dispatch" in self.parent.ids:
            self.ids.setdefault("dispatch", self.parent.ids["dispatch"])
        self.sid = next(tr._sids)
        self.tid = threading.get_ident()
        stack.append(self)
        if self.t0 is None:
            self.t0 = tr.now()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        t1 = tr.now()
        tr._stack().pop()
        tr._records.append(SpanRecord(self.sid, self.name, self.t0, t1, self.tid,
                                      None if self.parent is None else self.parent.sid,
                                      self.ids))
        return False


def _ids(request, dispatch, requests) -> Dict[str, Any]:
    """A span's ids, those given."""
    ids: Dict[str, Any] = {}
    if request is not None:
        ids["request"] = request
    if dispatch is not None:
        ids["dispatch"] = dispatch
    if requests is not None:
        ids["requests"] = requests
    return ids


def clock_pair() -> Tuple[int, int]:
    """(time.time_ns(), time.perf_counter_ns()) at one instant: of five
    back-to-back reads, the wall read closest bracketed by two
    perf_counter reads, paired with their midpoint."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall, (a + b) // 2)
    return best[1], best[2]


def read_counters() -> Dict[str, Dict[str, int]]:
    """The kernels' counters where they live: each loaded
    ``haconvdr_torch.ops`` module's ``COUNTS``, by ``ops.<module>``, with
    what its ``device_counts()`` reads off the device where it has one (a
    sync: call it outside the forward)."""
    out: Dict[str, Dict[str, int]] = {}
    for name, mod in list(sys.modules.items()):
        counts = getattr(mod, "COUNTS", None) if name.startswith("haconvdr_torch.ops.") else None
        if isinstance(counts, dict):
            counts = dict(counts)
            on_device = getattr(mod, "device_counts", None)
            if callable(on_device):
                counts.update(on_device())
            out[name[len("haconvdr_torch."):]] = counts
    return out


def counter_deltas(before: Dict, after: Dict) -> Dict[str, Dict[str, int]]:
    """after - before, key by key (a module loaded in between counts from 0)."""
    return {group: {k: v - before.get(group, {}).get(k, 0) for k, v in counts.items()}
            for group, counts in after.items()}


@dataclasses.dataclass
class Snapshot:
    """What one ``start()`` .. ``stop()`` recorded."""

    wall_ns: int  # time.time_ns() at start(), the profiler's host clock
    perf_ns: int  # time.perf_counter_ns() at the same instant
    spans: List[SpanRecord]
    counters: Dict[str, Dict[str, int]]  # the kernels' deltas since start()

    def profiler_ns(self, t_perf_ns: int) -> int:
        """A span's perf_counter_ns time on the profiler's ns clock (the
        wall clock: torch.profiler stamps its host events with it)."""
        return self.wall_ns + (t_perf_ns - self.perf_ns)

    def of(self, name: str) -> List[SpanRecord]:
        return [s for s in self.spans if s.name == name]


class Tracer:
    """Spans and counter deltas of the serving path (module docstring)."""

    def __init__(self):
        self.on = False
        self.now = time.perf_counter_ns  # the tracer's one clock
        self._records: List[SpanRecord] = []
        self._local = threading.local()
        self._sids = itertools.count()
        self._pair = (0, 0)  # (time_ns, perf_counter_ns) at start()
        self._before: Dict = {}

    def start(self) -> None:
        self._records = []
        self._before = read_counters()
        self._pair = clock_pair()
        self.on = True

    @property
    def started(self) -> int:
        """perf_counter_ns at the last start()."""
        return self._pair[1]

    def stop(self) -> Snapshot:
        self.on = False
        after = read_counters()
        return Snapshot(self._pair[0], self._pair[1], list(self._records),
                        counter_deltas(self._before, after))

    def span(self, name: str, t0: Optional[int] = None, *, request: Optional[int] = None,
             dispatch: Optional[int] = None, requests: Optional[List[int]] = None):
        """A context that records ``name`` while tracing is on (``t0``:
        a start read earlier from ``now``), else ``NULL_SPAN``.  The ids
        are named parameters, so a call while off allocates nothing."""
        if not self.on:
            return NULL_SPAN
        return _Span(self, name, t0, _ids(request, dispatch, requests))

    def record(self, name: str, t0: int, t1: int, tid: Optional[int], *,
               request: Optional[int] = None, dispatch: Optional[int] = None) -> None:
        """A finished interval that no ``with`` encloses (tracing on)."""
        self._records.append(SpanRecord(next(self._sids), name, t0, t1, tid, None,
                                        _ids(request, dispatch, None)))

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


TRACER = Tracer()
