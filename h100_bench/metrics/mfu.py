"""Device: the least time of the window's work (tower and search) over the window's wall, %."""

from h100_bench.harness.readers import mfu_pct


def read(r):
    return mfu_pct(r)
