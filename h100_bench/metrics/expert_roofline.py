"""Kernels: the least time of the expert layer's work over the window (2 x
assignments x 3 x H x I bf16 operations a layer, the experts' weights read
once a call; ``harness/work_moe.expert_work``) over the device time of the
expert kernels' launches (routing and the grouped products), %.  None where
no such kernel ran."""

from h100_bench.harness.experts import expert_device_s


def read(r):
    dev = expert_device_s(r)
    work = r.counters.get("expert_work")
    if not dev or work is None or not work.ops:
        return None
    return 100.0 * work.least_seconds() / dev
