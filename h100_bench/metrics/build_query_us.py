"""Query build: mean host time of Retriever.build_query a request, us."""

from h100_bench.harness.readers import span_mean_s


def read(r):
    s = span_mean_s(r, "build_query")
    return None if s is None else s * 1e6
