"""Tower: mean host time of the port's tower.launch spans a dispatch (the tower's
launches, before the host sync), ms."""

from h100_bench.harness.port_trace import per_dispatch_ms


def read(r):
    return per_dispatch_ms(r, "tower.launch")
