"""What a run prints on standard error beside its result (none of it is a
metric): set-up by step, the window's shape, the garbage collector's
pauses, this process's CPU time, and the card's clock, power and
temperature (nvidia-smi) before and after the window."""

from __future__ import annotations

import gc
import json
import resource
import subprocess
import sys
import time

import numpy as np


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader,nounits", "--id=0"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


class Machine:
    def __enter__(self):
        self.card0 = _card()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        return self

    def __exit__(self, *exc):
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        self.stats = {
            "process_cpu_s": round(ru1.ru_utime + ru1.ru_stime
                                   - self.ru0.ru_utime - self.ru0.ru_stime, 3),
            "card_before": self.card0, "card_after": _card(),
        }
        return False


class GcPauses:
    """The garbage collector's pauses during the window, by generation
    (reported on standard error beside the window's shape)."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds[info["generation"]] += time.perf_counter() - self._t
            self.count[info["generation"]] += 1

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)
        return False


def quantiles(values, scale):
    q = np.percentile(values, [50, 95, 99, 100]) * scale if len(values) else [float("nan")] * 4
    return {"p50": float(q[0]), "p95": float(q[1]), "p99": float(q[2]), "max": float(q[3])}


def report(marks, stats) -> None:
    """Set-up by step and the window's shape, on standard error (not part
    of the result)."""
    steps = {b[0]: round(b[1] - a[1], 3) for a, b in zip(marks, marks[1:])}
    print("h100_bench set-up s:", json.dumps(steps), file=sys.stderr)
    print("h100_bench window:", json.dumps(stats), file=sys.stderr)
