"""Device: the card's idle time while the batcher's worker did host work (its
dispatch's own code, collate, copies in, launches, resolve, code outside its
spans), ms a dispatch."""

from h100_bench.harness.port_trace import HOST, idle_per_dispatch_ms


def read(r):
    return idle_per_dispatch_ms(r, HOST)
