"""What the expert layer's readers (``metrics/expert_*.py``) share: the
device time of its kernels (csrc/moe_experts.cu) in a traced window."""

from __future__ import annotations

from typing import Optional

from h100_bench.harness.readers import Reading

# kernel names of the expert layer
EXPERT_KERNELS = ("moe_route_kernel", "moe_gemm_kernel")


def expert_device_s(r: Reading) -> Optional[float]:
    """Device seconds of the expert kernels launched inside the tower's
    spans (``embed``), or None without a trace."""
    if r.trace is None:
        return None
    return sum(b - a for name, a, b, span in r.trace.ops
               if span == "embed" and any(k in name for k in EXPERT_KERNELS))
