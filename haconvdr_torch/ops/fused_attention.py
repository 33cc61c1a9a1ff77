"""Inference attention from the fused QKV projection
(counterpart of haconvdr_tpu/ops/fused_attention.py).

``fused_attention_qkv`` launches the CUDA kernel
(csrc/fused_attention.cu) for CUDA tensors and runs the plain twin
``fused_attention_qkv_plain`` for CPU tensors; there is no other route.
Both take qkv ``[B, L, 3H]`` (the fused projection, head-interleaved as
``[q heads | k heads | v heads]``) and return the context ``[B, L, H]``.
"""

from __future__ import annotations

import math

import torch

from haconvdr_torch.ops import _build

# launches of the CUDA kernel / calls of the plain twin
COUNTS = {"kernel": 0, "plain": 0}
MAX_L = 512
HEAD_DIMS = (64,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_supported(L: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Shapes the CUDA kernel takes: L <= 512, head dim 64, f32 or bf16."""
    return 0 < L <= MAX_L and head_dim in HEAD_DIMS and dtype in _DTYPE_CODE


def fused_attention_qkv_plain(
    qkv: torch.Tensor, attention_mask: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """The kernel's math in plain PyTorch: f32 scores (exact products of
    bf16 operands), additive -1e9 padding bias, f32 softmax, P rounded to
    V's dtype, f32 accumulation, output in qkv's dtype."""
    COUNTS["plain"] += 1
    B, L, H3 = qkv.shape
    H = H3 // 3
    d = H // num_heads
    acc = torch.promote_types(qkv.dtype, torch.float32)

    def heads(t):  # [B, L, H] -> [B, heads, L, d]
        return t.reshape(B, L, num_heads, d).transpose(1, 2).to(acc)

    q, k, v = heads(qkv[..., :H]), heads(qkv[..., H : 2 * H]), heads(qkv[..., 2 * H :])
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    bias = (1.0 - attention_mask.to(acc)) * -1e9
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    o = p.to(qkv.dtype).to(acc) @ v
    return o.transpose(1, 2).reshape(B, L, H).to(qkv.dtype)


def _check(qkv: torch.Tensor, attention_mask: torch.Tensor, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [B, L, 3H], got {tuple(qkv.shape)}")
    B, L, H3 = qkv.shape
    H = H3 // 3
    if num_heads <= 0 or H % num_heads:
        raise ValueError(f"hidden {H} not divisible by {num_heads} heads")
    if not fused_attention_supported(L, H // num_heads, qkv.dtype):
        raise ValueError(
            f"fused attention kernel takes L <= {MAX_L}, head dim in "
            f"{HEAD_DIMS}, float32/bfloat16; got L={L}, "
            f"head dim {H // num_heads}, {qkv.dtype}"
        )
    if tuple(attention_mask.shape) != (B, L):
        raise ValueError(
            f"attention_mask must be [{B}, {L}], got {tuple(attention_mask.shape)}"
        )
    if attention_mask.device != qkv.device:
        raise ValueError("qkv and attention_mask must be on one device")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")


def fused_attention_qkv(
    qkv: torch.Tensor, attention_mask: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Attention context [B, L, H] from the fused projection [B, L, 3H]."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_plain(qkv, attention_mask, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    _check(qkv, attention_mask, num_heads)
    lib = _build.library()
    B, L, H3 = qkv.shape
    mask = attention_mask.to(torch.int32).contiguous()
    out = torch.empty((B, L, H3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_fused_attention(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, L, H3 // 3, num_heads, _DTYPE_CODE[qkv.dtype], stream,
        )
    _build.check(err, "hc_fused_attention")
    COUNTS["kernel"] += 1
    return out
