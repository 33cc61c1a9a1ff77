"""Tower (corpus encode): device time of what one encode_fn call (the embed span) launched, ms a batch."""

def read(r):
    if r.trace is None or r.spans is None:
        return None
    n = len(r.spans.of("embed"))
    dev = r.trace.span_device_s("embed")
    return dev / n * 1e3 if n and dev > 0 else None
