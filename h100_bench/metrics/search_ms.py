"""Search: mean host time of Retriever.search a dispatch (it ends on the host sync), ms."""

from h100_bench.harness.readers import span_mean_s


def read(r):
    s = span_mean_s(r, "search")
    return None if s is None else s * 1e3
