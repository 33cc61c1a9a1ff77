"""Batcher: requests a dispatch in the window, from BatchingRetriever.stats()."""

def read(r):
    d = r.counters.get("dispatches")
    return r.counters["queries"] / d if d else None
