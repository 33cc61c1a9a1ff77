"""(residual +) LayerNorm (+ per-row int8 quantization) in one pass
(counterpart of haconvdr_tpu/ops/fused_ln.py).

``fused_residual_ln`` and ``fused_residual_ln_quant`` launch the CUDA
kernel (csrc/fused_ln.cu) for CUDA tensors and run their plain twins
``fused_residual_ln_plain`` / ``fused_residual_ln_quant_plain`` for CPU
tensors; there is no other route.  Contract of all four:

* ``t = x + residual`` is added in x's dtype (the carry: a bfloat16 sum
  rounds to bfloat16), or ``t = x`` when ``residual`` is None;
* ``y = LayerNorm(t)`` in float32 (mean, then the variance of the centred
  values), times ``scale`` plus ``bias``, returned in ``out_dtype``
  (default x's dtype);
* the quant variant also returns ``yq`` int8 and ``ys`` float32 [..., 1]:
  the dynamic per-row quantization of the returned (rounded) y, exactly
  what the consuming int8 dense would compute from it (``quantize_rows``).

The TPU module's gates (``fused_ln_supported``: a TPU backend, row counts
divisible by a tile) do not carry over: the kernel takes any row count and
hidden sizes H % 32 == 0 up to 1024, and raises ``ValueError`` on CUDA for
anything else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from haconvdr_torch.index.quantize import quantize_rows
from haconvdr_torch.ops import _build

# launches of the CUDA kernel without / with the quant tail; plain-twin calls
COUNTS = {"ln": 0, "ln_quant": 0, "plain": 0}
MAX_H = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """LayerNorm in promote(x.dtype, float32) (the encoder's
    ``_layer_norm``, haconvdr_tpu/models/encoder.py:94-106); ``out_dtype``
    None keeps that dtype."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * weight.to(y.dtype) + bias.to(y.dtype)
    return y if out_dtype is None else y.to(out_dtype)


def _residual_ln(x, residual, scale, bias, eps, out_dtype):
    if residual is not None:
        x = x + residual.to(x.dtype)
    return layer_norm(x, scale, bias, eps, out_dtype=out_dtype or x.dtype)


def fused_residual_ln_plain(
    x: torch.Tensor, residual: Optional[torch.Tensor], scale: torch.Tensor,
    bias: torch.Tensor, eps: float = 1e-12, out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``LayerNorm(x + residual)`` in plain PyTorch (see module docstring)."""
    COUNTS["plain"] += 1
    return _residual_ln(x, residual, scale, bias, eps, out_dtype)


def fused_residual_ln_quant_plain(
    x: torch.Tensor, residual: Optional[torch.Tensor], scale: torch.Tensor,
    bias: torch.Tensor, eps: float = 1e-12, out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, yq, ys)`` in plain PyTorch (see module docstring)."""
    COUNTS["plain"] += 1
    y = _residual_ln(x, residual, scale, bias, eps, out_dtype)
    yq, ys = quantize_rows(y)
    return y, yq, ys


def _launch(x, residual, scale, bias, eps, out_dtype, quant: bool):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    H = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(
            f"fused LayerNorm kernel takes float32/bfloat16 in and out; got "
            f"{x.dtype} -> {out_dtype}"
        )
    if H % 32 or not 32 <= H <= MAX_H:
        raise ValueError(f"fused LayerNorm kernel takes H % 32 == 0, 32 <= H <= {MAX_H}; got {H}")
    if x.numel() == 0:
        raise ValueError("fused LayerNorm kernel needs at least one row")
    if residual is not None:
        if residual.shape != x.shape or residual.device != x.device:
            raise ValueError(
                f"residual must match x ({tuple(x.shape)} on {x.device}); got "
                f"{tuple(residual.shape)} on {residual.device}"
            )
        residual = residual.to(x.dtype).contiguous()
    if tuple(scale.shape) != (H,) or tuple(bias.shape) != (H,):
        raise ValueError(f"scale and bias must be [{H}]")
    lib = _build.library()
    x = x.contiguous()
    rows = x.numel() // H
    sc = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bi = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    yq = torch.empty(x.shape, dtype=torch.int8, device=x.device) if quant else None
    ys = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device) if quant else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_fused_ln(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            sc.data_ptr(), bi.data_ptr(), float(eps), rows, H,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
            y.data_ptr(), None if yq is None else yq.data_ptr(),
            None if ys is None else ys.data_ptr(), stream,
        )
    _build.check(err, "hc_fused_ln")
    COUNTS["ln_quant" if quant else "ln"] += 1
    return (y, yq, ys) if quant else y


def fused_residual_ln(
    x: torch.Tensor, residual: Optional[torch.Tensor], scale: torch.Tensor,
    bias: torch.Tensor, eps: float = 1e-12, out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``LayerNorm(x + residual)``: the kernel on CUDA, the twin on the CPU."""
    if x.device.type == "cpu":
        return fused_residual_ln_plain(x, residual, scale, bias, eps, out_dtype)
    return _launch(x, residual, scale, bias, eps, out_dtype, quant=False)


def fused_residual_ln_quant(
    x: torch.Tensor, residual: Optional[torch.Tensor], scale: torch.Tensor,
    bias: torch.Tensor, eps: float = 1e-12, out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, yq, ys)``: the kernel on CUDA, the twin on the CPU."""
    if x.device.type == "cpu":
        return fused_residual_ln_quant_plain(x, residual, scale, bias, eps, out_dtype)
    return _launch(x, residual, scale, bias, eps, out_dtype, quant=True)
