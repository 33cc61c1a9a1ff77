"""Kernels: the search's least time over the device time of what Retriever.search launched, %."""

from h100_bench.harness.readers import roofline_pct


def read(r):
    return roofline_pct(r, "search")
