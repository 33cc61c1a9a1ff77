"""Batcher: mean host time of the port's batcher.resolve spans a dispatch (the
answers built, the futures resolved), ms."""

from h100_bench.harness.port_trace import per_dispatch_ms


def read(r):
    return per_dispatch_ms(r, "batcher.resolve")
