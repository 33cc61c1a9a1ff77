"""The int8 MLP block of an inference tower (counterpart of
haconvdr_tpu/ops/fused_mlp.py).

``fused_mlp_block`` launches the CUDA kernels (csrc/fused_mlp.cu: the
up-projection with GELU, the codes of its output, the down-projection with
the residual, then fused_ln.cu's LayerNorm with codes; one call, counted
once) for CUDA tensors and runs the plain twin ``fused_mlp_block_plain``
for CPU tensors; there is no other route.  Both compute, from the carry
``x`` (bfloat16) and its prequantization ``(xq, xs)``::

    y1 = int8_dense(xq, xs, W1) -> bfloat16;   g = tanh-GELU(y1) (bfloat16)
    gq, gs = quantize_rows(g);                 y2 = int8_dense(gq, gs, W2)
    y = LayerNorm(x + y2 in bfloat16) -> out_dtype;  yq, ys = quantize_rows(y)

and return ``(y, yq, ys)``: the next carry and its prequantization.  The
weights are int8 in ``nn.Linear``'s [out, in] layout (the JAX function
takes them [in, out]); ``kernel_scale`` is per output channel.  The
kernels take H % 64 == 0 up to 1024 and I % 64 == 0 up to 131,072 (exact
int32 sums), any row count, and raise ``ValueError`` on CUDA otherwise
(the TPU module's ``fused_mlp_supported`` gates do not carry over).  The
wrapper allocates their scratch: ``scratch_bytes_per_row`` bytes a row
(10,760 at H 768, I 3072).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from haconvdr_torch.index.quantize import quantize_rows
from haconvdr_torch.ops import _build
from haconvdr_torch.ops.fused_ln import layer_norm

# launches of the CUDA kernel / plain-twin calls
COUNTS = {"kernel": 0, "plain": 0}
MAX_H = 1024
MAX_I = 131_072  # I * 127 * 127 < 2**31: the int32 sums stay exact
ROWS_PER_BLOCK = 128  # rows of a product tile (csrc/fused_mlp.cu: BM)


def _int_mm(a: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a [M, K] @ weight [N, K]^T`` (``torch._int_mm``; on
    CUDA it needs M > 16, so fewer rows are padded with zeros)."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, a.shape[1]))])
    return torch._int_mm(a.contiguous(), weight.t())[:m]


def int8_dense(
    xq: torch.Tensor, xs: torch.Tensor, weight: torch.Tensor,
    kernel_scale: torch.Tensor, bias: torch.Tensor,
) -> torch.Tensor:
    """The int8 dense of haconvdr_tpu/models/encoder.py:137-139, float32
    out: ``(xq . W)_int32 * (xs / 127) * kernel_scale + bias``.  ``xq``
    int8 [..., K] with row scales ``xs`` [..., 1]; ``weight`` int8 [N, K]."""
    lead = xq.shape[:-1]
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), weight)
    xs = xs.reshape(-1, 1).to(torch.float32)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which can differ from xs / 127 by one ulp
    xs_127 = xs / torch.full_like(xs, 127.0)
    y = acc.to(torch.float32) * xs_127 * kernel_scale + bias
    return y.reshape(*lead, weight.shape[0])


def fused_mlp_block_plain(
    x: torch.Tensor, xq: torch.Tensor, xs: torch.Tensor,
    w1: torch.Tensor, w1_scale: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, w2_scale: torch.Tensor, b2: torch.Tensor,
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    eps: float = 1e-12, out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unfused composition (see module docstring)."""
    COUNTS["plain"] += 1
    inter = int8_dense(xq, xs, w1, w1_scale, b1).to(torch.bfloat16)
    gq, gs = quantize_rows(F.gelu(inter, approximate="tanh"))
    y2 = int8_dense(gq, gs, w2, w2_scale, b2)
    y = layer_norm(x + y2.to(x.dtype), ln_scale, ln_bias, eps, out_dtype=out_dtype or x.dtype)
    yq, ys = quantize_rows(y)
    return y, yq, ys


def smem_bytes(hidden: int, inter: int) -> int:
    """Dynamic shared memory of one product block (csrc/fused_mlp.cu:SMEM:
    three stages of 128-byte k chunks of 128 A rows and 128 W rows), the
    same at every width."""
    return 3 * (ROWS_PER_BLOCK + 128) * 128


def scratch_bytes_per_row(hidden: int, inter: int) -> int:
    """Scratch the wrapper allocates a row: g (bf16) and its codes [I],
    its row maximum and scale, and the residual sum t (bf16) [H]."""
    return 3 * inter + 2 * hidden + 8


def fused_mlp_supported(hidden: int, inter: int) -> bool:
    """Widths the CUDA kernels take (any row count)."""
    return (
        hidden % 64 == 0 and 64 <= hidden <= MAX_H and inter % 64 == 0
        and 64 <= inter <= MAX_I
    )


def fused_mlp_block(
    x: torch.Tensor, xq: torch.Tensor, xs: torch.Tensor,
    w1: torch.Tensor, w1_scale: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, w2_scale: torch.Tensor, b2: torch.Tensor,
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    eps: float = 1e-12, out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, yq, ys)``: the kernel on CUDA, the twin on the CPU."""
    args = (x, xq, xs, w1, w1_scale, b1, w2, w2_scale, b2, ln_scale, ln_bias)
    if x.device.type == "cpu":
        return fused_mlp_block_plain(*args, eps=eps, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    H = x.shape[-1]
    I = w1.shape[0]
    if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise ValueError(f"fused MLP kernel takes a bfloat16 carry; got {x.dtype} -> {out_dtype}")
    if not fused_mlp_supported(H, I):
        raise ValueError(
            f"fused MLP kernel takes H % 64 == 0 (<= {MAX_H}) and I % 64 == 0 "
            f"(<= {MAX_I}); got H={H}, I={I}"
        )
    if xq.shape != x.shape or xq.dtype != torch.int8 or xs.numel() * H != x.numel():
        raise ValueError("xq must be int8 of x's shape and xs one scale per row")
    if w1.dtype != torch.int8 or w2.dtype != torch.int8 or tuple(w1.shape) != (I, H) \
            or tuple(w2.shape) != (H, I):
        raise ValueError(f"w1 must be int8 [{I}, {H}] and w2 int8 [{H}, {I}]")
    if x.numel() == 0:
        raise ValueError("fused MLP kernel needs at least one row")
    for t in args:
        if t.device != x.device:
            raise ValueError("every operand must be on x's device")
    w1, w2 = w1.contiguous(), w2.contiguous()
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("w1 and w2 must be 16-byte aligned")

    def vec(t, n):
        if t.numel() != n:
            raise ValueError(f"expected a vector of {n}, got {tuple(t.shape)}")
        return t.to(torch.float32).contiguous()

    s1, bb1 = vec(w1_scale, I), vec(b1, I)
    s2, bb2, lns, lnb = vec(w2_scale, H), vec(b2, H), vec(ln_scale, H), vec(ln_bias, H)
    lib = _build.library()
    x, xq = x.contiguous(), xq.contiguous()
    if xq.data_ptr() % 16 or x.data_ptr() % 4:
        raise ValueError("xq must start on a 16-byte boundary (cp.async) and x on 4 bytes")
    xs = xs.to(torch.float32).contiguous()
    rows = x.numel() // H
    dev = x.device
    y = torch.empty(x.shape, dtype=out_dtype, device=dev)
    yq = torch.empty(x.shape, dtype=torch.int8, device=dev)
    ys = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=dev)
    # one allocation for the scratch: g (bf16 [rows, I]), gq (int8
    # [rows, I]), t (bf16 [rows, H]), gmax, gs ([rows] each); every part
    # starts on a 64-byte boundary since H and I are multiples of 64
    scratch = torch.empty(rows * scratch_bytes_per_row(H, I), dtype=torch.uint8, device=dev)
    g_at, gq_at = 0, rows * I * 2
    t_at = gq_at + rows * I
    gmax_at = t_at + rows * H * 2
    gs_at = gmax_at + rows * 4
    ptr = scratch.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_fused_mlp(
            x.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            w1.data_ptr(), s1.data_ptr(), bb1.data_ptr(),
            w2.data_ptr(), s2.data_ptr(), bb2.data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), float(eps), rows, H, I,
            y.data_ptr(), yq.data_ptr(), ys.data_ptr(),
            ptr + g_at, ptr + gmax_at, ptr + gq_at, ptr + gs_at, ptr + t_at, stream,
        )
    _build.check(err, "hc_fused_mlp")
    COUNTS["kernel"] += 1
    return y, yq, ys
