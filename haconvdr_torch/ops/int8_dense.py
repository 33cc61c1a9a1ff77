"""The int8 dense of an inference tower (``models.encoder.Int8Linear``):
the per-token int8 codes of the input, the int8 product with exact int32
sums, and its dequantization, bias and cast (the JAX package's ``_dense``,
haconvdr_tpu/models/encoder.py:114-139, which it leaves to XLA).

``int8_dense`` launches the CUDA kernels (csrc/int8_dense.cu) for CUDA
tensors and runs the plain twin ``int8_dense_plain`` for CPU tensors; there
is no other route.  Both compute, from x [..., K] (bfloat16 or float32) or
its given codes ``prequant = (xq, xs)``::

    xq, xs = quantize_rows(x)                                  (row_codes)
    y = (xq . W^T)_int32 -> f32 * (xs / 127) * kernel_scale + bias -> out_dtype

with every float step rounded on its own (``fused_mlp.int8_dense``), so the
kernels give the twin's bits.  ``weight`` is int8 [N, K] (``nn.Linear``'s
layout); ``kernel_scale`` and ``bias`` are per output channel; ``out_dtype``
None means float32.  The kernels take K % 64 == 0 up to 131,072 (exact
int32 sums) and N % 64 == 0 (``int8_dense_supported``), any row count, the
codes, x and W on 16-byte boundaries, and raise ``ValueError`` on CUDA
otherwise.  ``COUNTS``: ``dense`` and ``codes`` kernel launches (codes
only where no ``prequant`` came), ``plain`` twin calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from haconvdr_torch.index.quantize import quantize_rows
from haconvdr_torch.ops import _build, fused_mlp

COUNTS = {"dense": 0, "codes": 0, "plain": 0}
MAX_K = fused_mlp.MAX_I  # K * 127 * 127 < 2**31: the int32 sums stay exact
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def int8_dense_supported(K: int, N: int) -> bool:
    """Widths the CUDA kernels take (any row count)."""
    return K % 64 == 0 and 64 <= K <= MAX_K and N % 64 == 0 and N >= 64


def int8_dense_plain(
    x: torch.Tensor, weight: torch.Tensor, kernel_scale: torch.Tensor, bias: torch.Tensor,
    prequant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The composition the kernels replace: ``quantize_rows``,
    ``torch._int_mm`` and the float32 dequantization, then the cast."""
    COUNTS["plain"] += 1
    xq, xs = quantize_rows(x) if prequant is None else prequant
    y = fused_mlp.int8_dense(xq, xs, weight, kernel_scale, bias)
    return y if out_dtype is None else y.to(out_dtype)


def _aligned(t: torch.Tensor, what: str) -> torch.Tensor:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and start on a 16-byte boundary")
    return t


def row_codes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows(x)`` by csrc/int8_dense.cu's row_codes kernel: x
    [..., K] bfloat16 or float32 on CUDA -> (int8 [..., K], float32 [..., 1])."""
    K = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or K % 64 or not 64 <= K <= MAX_K:
        raise ValueError(f"row codes take bfloat16 or float32 rows of K % 64 == 0 "
                         f"(<= {MAX_K}); got {x.dtype}, K={K}")
    _aligned(x, "x")
    rows = x.numel() // K
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    xs = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_row_codes(x.data_ptr(), rows, K, _DTYPE_CODE[x.dtype], xq.data_ptr(),
                               xs.data_ptr(), stream)
    _build.check(err, "hc_row_codes")
    COUNTS["codes"] += 1
    return xq, xs


def int8_dense(
    x: torch.Tensor, weight: torch.Tensor, kernel_scale: torch.Tensor, bias: torch.Tensor,
    prequant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``y`` [..., N]: the kernels on CUDA (the codes of x first where no
    ``prequant`` came), the twin on the CPU."""
    if x.device.type == "cpu":
        return int8_dense_plain(x, weight, kernel_scale, bias, prequant, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out_dtype = out_dtype or torch.float32
    N, K = weight.shape
    if weight.dtype != torch.int8 or weight.dim() != 2:
        raise ValueError(f"weight must be int8 [N, K]; got {weight.dtype} {tuple(weight.shape)}")
    if not int8_dense_supported(K, N):
        raise ValueError(f"int8 dense kernel takes K % 64 == 0 (<= {MAX_K}) and N % 64 == 0; "
                         f"got K={K}, N={N}")
    if x.shape[-1] != K or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"x must end in K={K} and out_dtype be float32 or bfloat16")
    if kernel_scale.numel() != N or bias.numel() != N:
        raise ValueError(f"kernel_scale and bias must hold {N} values")
    for t in (weight, kernel_scale, bias) + (() if prequant is None else tuple(prequant)):
        if t.device != x.device:
            raise ValueError("every operand must be on x's device")
    _aligned(weight, "weight")
    ks = kernel_scale.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    if ks.data_ptr() % 8 or b.data_ptr() % 8:
        raise ValueError("kernel_scale and bias must start on an 8-byte boundary")
    if prequant is not None:
        xq, xs = prequant
        if xq.dtype != torch.int8 or xq.shape != x.shape or xs.numel() * K != x.numel():
            raise ValueError("prequant must be int8 codes of x's shape and one scale a row")
        _aligned(xq, "xq")
    y = torch.empty(x.shape[:-1] + (N,), dtype=out_dtype, device=x.device)
    rows = x.numel() // K
    if rows == 0:
        return y
    if prequant is None:
        xq, xs = row_codes(x)
    xs = xs.to(torch.float32).contiguous()
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_int8_dense(xq.data_ptr(), xs.data_ptr(), weight.data_ptr(), ks.data_ptr(),
                                b.data_ptr(), rows, N, K, _DTYPE_CODE[out_dtype], y.data_ptr(),
                                stream)
    _build.check(err, "hc_int8_dense")
    COUNTS["dense"] += 1
    return y
