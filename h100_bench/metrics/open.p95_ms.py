"""Request path (the open loop): the 95th percentile of every request's
latency from the time it was due, ms.  At 0.8 of the knee the batcher
here is bound by the host, and this tail swings with the host's speed
run to run (PERF.md), so it is a per-layer reading and not a bound."""


def read(r):
    return r.counters.get("p95_ms")
