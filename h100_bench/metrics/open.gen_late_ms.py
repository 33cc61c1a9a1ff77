"""Load generator: the 95th percentile of (sent - due) over an open loop's requests, ms."""

import numpy as np


def read(r):
    late = r.counters.get("gen_late_s")
    return float(np.percentile(late, 95)) * 1e3 if late else None
