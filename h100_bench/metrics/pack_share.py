"""Tower: the share of the batches' token slots (B x L as they reached the
tower) that its token-wise layers ran, ``rows / slots`` of the port's
``ops.pack.COUNTS``, in %.  Under ``run.py`` the process's totals over
set-up, warm-up and the window; under ``port_split.py`` the window's
deltas.  None for a port without the counter (it runs every slot)."""

from h100_bench.harness.port_trace import snapshot_of


def read(r):
    snap = snapshot_of(r)
    if snap is not None:
        counts = snap.counters.get("ops.pack")
    else:
        try:
            from haconvdr_torch.utils.telemetry import read_counters
        except ImportError:  # a port without the tracer
            return None
        counts = read_counters().get("ops.pack")
    if not counts or not counts.get("slots"):
        return None
    return 100.0 * counts["rows"] / counts["slots"]
