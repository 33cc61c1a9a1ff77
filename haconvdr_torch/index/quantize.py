"""Symmetric int8 scalar quantization of embedding indexes (counterpart of
haconvdr_tpu/index/quantize.py, and of the per-query quantization in
haconvdr_tpu/ops/pallas_topk_v4.py:855-861).

The numpy pair ``quantize_int8`` / ``dequantize_int8`` is the port's own
copy of the JAX package's (the same formula, so blocks written by either
package read in the other).  The torch functions here give the same codes
on tensors that already live on the device:

* index rows: per-dimension scale ``max|x[:, d]| / 127`` (1 for an
  all-zero dimension), codes ``clip(round(x / scale), -127, 127)`` with
  round half to even;
* queries: per-query scale ``q_scale = max(max|q|, 1e-30)``, codes
  ``clip(round(q / q_scale * 127), -127, 127)``; a score of int8 codes
  dequantizes as ``s * (q_scale / 127)``.  ``quantize_rows`` is the same
  per-row quantization on any [..., D] tensor: the int8 encoder's dynamic
  per-token activation codes (haconvdr_tpu/models/encoder.py:131-136).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "dequantize_int8",
    "quantize_int8",
    "quantize_int8_torch",
    "quantize_queries_int8",
    "quantize_rows",
    "encode_int8_torch",
]

_ROWS = 65536  # rows per pass: bounds the float32 temporaries on the device


def quantize_int8(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] float -> ([N, D] int8, [D] float32 per-dim scales).
    Symmetric, zero-offset; all-zero dimensions get scale 1."""
    emb = np.asarray(emb, np.float32)
    amax = np.abs(emb).max(axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(emb / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Exact float32 reconstruction the int8 search path scores against."""
    return q.astype(np.float32) * np.asarray(scale, np.float32)


def encode_int8_torch(emb: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``clip(round(emb * factor), -127, 127)`` as int8, in row chunks.
    ``factor`` [D] float32 is ``1 / scale`` for float rows, or
    ``old_scale / new_scale`` to requantize int8 codes."""
    out = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
    for r0 in range(0, emb.shape[0], _ROWS):
        x = emb[r0 : r0 + _ROWS].to(torch.float32) * factor
        out[r0 : r0 + _ROWS] = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    return out


def quantize_int8_torch(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, D] float tensor -> ([N, D] int8, [D] float32 scales) on the same
    device, equal to ``quantize_int8`` on the same values."""
    if emb.dim() != 2:
        raise ValueError(f"expected [N, D] embeddings, got {tuple(emb.shape)}")
    amax = torch.zeros(emb.shape[1], dtype=torch.float32, device=emb.device)
    for r0 in range(0, emb.shape[0], _ROWS):
        chunk = emb[r0 : r0 + _ROWS].to(torch.float32).abs().amax(dim=0)
        amax = torch.maximum(amax, chunk)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
    for r0 in range(0, emb.shape[0], _ROWS):
        x = emb[r0 : r0 + _ROWS].to(torch.float32) / scale
        codes[r0 : r0 + _ROWS] = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    return codes, scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float -> ([..., D] int8 codes, [..., 1] float32 scales):
    ``s = max(max|x|, 1e-30)`` per row, codes ``clip(round(x / s * 127),
    -127, 127)`` computed in float32 with an IEEE division."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-30)
    q = torch.clamp(torch.round(xf / s * 127.0), -127, 127)
    return q.to(torch.int8), s


def quantize_queries_int8(qf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, D] float queries -> ([Q, D] int8 codes, [Q] float32 q_scale)."""
    q8, q_scale = quantize_rows(qf)
    return q8, q_scale[:, 0]
