"""Lightweight run telemetry (counterpart of haconvdr_tpu/utils/telemetry.py).

The reference's observability is stdlib logging of step losses every
print_steps (src/train_HAConvDR_topiocqa.py:191-197) and per-block search
latency dicts (src/test_HAConvDR_topiocqa.py:101-108).  Here a subsystem
can also emit structured events to a JSONL file (greppable, plottable):
``Trainer(metrics=MetricsLogger(path))`` logs one ``train_step`` event
(epoch, micro step, loss) per micro step, and ``Timer`` times a block
into the same sink.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

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


class Timer:
    """Context timer that reports into a MetricsLogger."""

    def __init__(self, metrics: Optional[MetricsLogger], event: str, **fields):
        self.metrics = metrics
        self.event = event
        self.fields = fields

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.start
        if self.metrics is not None:
            self.metrics.log(self.event, seconds=round(self.elapsed, 6), **self.fields)
        return False
