"""The rates a share of the chip is taken against (NVIDIA H100 SXM data
sheet, dense, at the full 700 W limit).

float32 is 165 TFLOP/s: 495 / 3, the rate of three TF32 products a
product, at which the port's float32 attention already reaches float32
accuracy; a later 3xTF32 GEMM would read over 100% against the 67 TFLOP/s
of the CUDA cores.  bfloat16 989 TFLOP/s, int8 1,979 TOP/s, HBM 3.35 TB/s.
"""

from __future__ import annotations

from typing import Dict

PEAK_OPS = {"float32": 165e12, "bfloat16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: Dict[str, float], nbytes: float) -> float:
    """The least time the chip could take for this work: the larger of its
    operations, each at its precision's rate and summed, and its bytes at
    the memory rate (one bound for the whole work, not a sum of parts')."""
    compute = sum(n / PEAK_OPS[p] for p, n in ops.items())
    return max(compute, nbytes / HBM_BYTES_PER_S)
