"""Device: the share of the traced window in which no operation ran, %."""

from h100_bench.harness.readers import idle_pct


def read(r):
    return idle_pct(r)
