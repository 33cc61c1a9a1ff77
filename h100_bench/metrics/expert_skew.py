"""Kernels (routing): the largest expert's load over the mean load, over the
window's expert-layer calls: the device accumulator's sum of the largest
load over the calls' mean loads (assignments / experts), from the deltas
of ``ops.moe``'s counters around the window.  1 is an even split."""


def read(r):
    d = r.counters.get("ops.moe")
    experts = r.counters.get("experts")
    if not d or not experts or not d.get("assignments") or "max_load_sum" not in d:
        return None
    return d["max_load_sum"] * experts / d["assignments"]
