"""Request path (a saturated closed loop): the 95th percentile of every
request's latency from the call to ``submit``, ms.  Where a dispatch takes
~430 ms (the DeepSeek-V2 tower) the window holds ~47 of them, and the tail
moves by a whole dispatch wherever the loop forms a few small batches (1-17
requests): at a cold window's start, and as often in a loop run 5 s before
its window opens.  So it is a per-layer reading and ``qps`` the end-to-end
metric."""


def read(r):
    return r.counters.get("p95_ms")
