"""Kernels: calls of the port's plain twins, the sum of every ``plain*`` key of
its ``ops.*.COUNTS`` (the north star: 0 on the card).  Under ``run.py`` the
process's totals over set-up, warm-up and the window (one run a process; no
driver hands over the tracer's snapshot yet); under ``port_split.py`` the
window's deltas."""

from h100_bench.harness.port_trace import plain_counts, snapshot_of


def read(r):
    snap = snapshot_of(r)
    if snap is not None:
        return plain_counts(snap.counters)
    try:
        from haconvdr_torch.utils.telemetry import read_counters
    except ImportError:  # a port without the tracer
        return None
    return plain_counts(read_counters())
