"""A traced run of a cell with the port's own tracer on over its window, on
the card:

    python3 h100_bench/port_split.py --workload <cell> --seed <n> --seconds 20

It runs the cell as ``run.py --trace 1`` does (the same set-up, window,
check and line: the same driver, wrapped) with
``haconvdr_torch.utils.telemetry.TRACER`` started where the window's loop
starts and stopped where it returns, the snapshot handed to the reading
(``harness/port_trace.PortReading``), and adds to the line:

* ``breakdown.idle_gaps_port``: the device's idle split by the batcher's
  worker's innermost port span (``port_trace.idle_by_port``);
* ``port``: the window's dispatches and the readers of ``metrics/`` that
  read the port's spans (``queue_wait_ms``, ``collate_ms``, ``launch_ms``,
  ``resolve_ms``, ``idle_wait_ms``, ``idle_host_ms``), with ``plain_calls``
  as the window's deltas;
* ``trace_diagnostics.port_launches``: the window's CUDA launch calls, and
  those outside the worker's launching spans (0 where the clock pair that
  places the port's spans on the profiler's clock holds).

The drivers do not start the tracer themselves yet; this wraps their
window loops (``closed_loop``, ``open_loop``; ``encode_corpus`` in the
encode cell, which has no batcher and so gives ``plain_calls`` alone).
Without a CUDA card, or with a port that has no ``TRACER``, it exits
with 2.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here, as in run.py

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from h100_bench import run as bench_run  # noqa: E402,F401  (its build caches)

# the readers of the port's spans and counters (metrics/<name>.py)
PORT_READERS = ("queue_wait_ms", "collate_ms", "launch_ms", "resolve_ms", "idle_wait_ms",
                "idle_host_ms", "plain_calls")


class Wiring:
    """The port's tracer over a driver's window, its snapshot in the reading."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.snap = None
        self.out = None  # the driver's result
        self.launches = None

    def window(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            self.tracer.start()
            try:
                return fn(*args, **kw)
            finally:
                self.snap = self.tracer.stop()
        return wrapped

    def reduce_profile(self, prof, spans, anchor, span_names):
        from h100_bench.harness import port_trace as P

        tr = P.reduce_profile(prof, spans, anchor, span_names)
        if tr is not None:
            self.launches = P.launches(list(prof.profiler.kineto_results.events()), self.snap)
        return tr

    def reading(self, spans, trace, counters):
        from h100_bench.harness.port_trace import PortReading

        return PortReading(spans, trace, counters, port=self.snap)

    def run(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            self.out = fn(*args, **kw)
            return self.out
        return wrapped

    @contextlib.contextmanager
    def installed(self, cell):
        """The cell's driver wrapped while inside: its window loop,
        reduce_profile, Reading and run (module attributes, looked up at
        call time), restored on the way out."""
        import haconvdr_torch.index.build as build

        d = cell.driver
        if hasattr(d, "closed_loop"):
            wraps = [(d, "closed_loop"), (d, "open_loop")]
        else:  # the encode driver imports encode_corpus when it runs
            wraps = [(build, "encode_corpus")]
        saved = [(obj, name, getattr(obj, name))
                 for obj, name in wraps + [(d, "reduce_profile"), (d, "Reading"), (d, "run")]]
        try:
            for obj, name in wraps:
                setattr(obj, name, self.window(getattr(obj, name)))
            d.reduce_profile, d.Reading, d.run = self.reduce_profile, self.reading, self.run(d.run)
            yield self
        finally:
            for obj, name, value in saved:
                setattr(obj, name, value)


def port_line(line, wiring) -> None:
    """The port's split, readers and launch check into the result's line."""
    from h100_bench.harness import port_trace as P
    from h100_bench.harness.cell import BENCH_DIR, load_module, reader_path

    r = wiring.out["reading"]
    port = {"dispatches": P.dispatches(wiring.snap)}
    for name in PORT_READERS:
        value = load_module(reader_path(BENCH_DIR, name)).read(r)
        if value is not None:
            port[name] = float(value)
    line["port"] = port
    split = P.idle_by_port(r.trace, wiring.snap)
    if split is not None and "breakdown" in line:
        line["breakdown"]["idle_gaps_port"] = split
    if "trace_diagnostics" in line:
        line["trace_diagnostics"]["port_launches"] = wiring.launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a traced run with the port's tracer on")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.runner import execute, forbidden_modules

    try:
        from haconvdr_torch.utils.telemetry import TRACER
    except ImportError:
        print("port_split.py: the port has no telemetry.TRACER", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_split.py: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    wiring = Wiring(TRACER)
    with wiring.installed(cell):
        line, correct = execute(cell, args.seed, args.seconds, True, torch.device("cuda", 0),
                                T_START)
    port_line(line, wiring)
    found = forbidden_modules()
    if found:
        print(f"port_split.py: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
