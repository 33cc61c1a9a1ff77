"""Device: the card's idle time while the batcher's worker waited for requests
(batcher.wait), ms a dispatch: demand, not the port's cost."""

from h100_bench.harness.port_trace import WAIT, idle_per_dispatch_ms


def read(r):
    return idle_per_dispatch_ms(r, WAIT)
