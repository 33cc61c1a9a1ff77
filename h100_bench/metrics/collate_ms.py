"""Tower: mean host time of the port's tower.collate spans a dispatch (the
batch iterator's next() in encode_batches, where a lazy iterator collates), ms.
Under the benchmark's traced runs the ``embed`` wrapper lists the batches
before the span, so it reads ~0 there."""

from h100_bench.harness.port_trace import per_dispatch_ms


def read(r):
    return per_dispatch_ms(r, "tower.collate")
