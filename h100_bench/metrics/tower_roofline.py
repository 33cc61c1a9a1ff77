"""Kernels: the tower's least time over the device time of what its span launched (Retriever.encode, or encode_corpus's encode_fn), %."""

from h100_bench.harness.readers import roofline_pct


def read(r):
    return roofline_pct(r, "embed")
