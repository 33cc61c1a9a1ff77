"""Batcher: the 95th percentile of the port's request.queue spans (enqueue to the
close of the request's batch) over the window's requests, ms."""

from h100_bench.harness.port_trace import queue_wait_p95_ms


def read(r):
    return queue_wait_p95_ms(r)
