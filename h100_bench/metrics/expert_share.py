"""Kernels: the device time of the expert layer's kernels (csrc/moe_experts.cu:
routing and the grouped products) over the device time of everything the
tower's spans (``embed``) launched, %.  None where no such kernel ran."""

from h100_bench.harness.experts import expert_device_s


def read(r):
    dev = expert_device_s(r)
    if not dev or r.trace is None:
        return None
    total = r.trace.span_device_s("embed")
    return 100.0 * dev / total if total > 0 else None
