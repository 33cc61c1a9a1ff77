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

Split mode (the pieces of a tensor-parallel tower's MLP block): the
inner dimension I is cut over a group of tp ranks, rank r holding the
rows ``[r I/tp, (r + 1) I/tp)`` of W1 (with their scales and biases) and
the same columns of W2.  ``split_up`` is a rank's up-projection on its
columns (g and its row maxima); ``split_down`` codes a rank's g with the
group's row maxima and multiplies by its W2 columns into raw int32
partials; ``split_finish`` sums the group's partials in int32 and
finishes as the block does (dequantization, residual, LayerNorm with
codes).  The codes and the int32 sums are the un-split block's, so the
pieces strung together over a group (``models.encoder.mlp_block_split``,
which takes the group maximum between the first two) give
``fused_mlp_block``'s result bit for bit, and the twins the un-split
twin's.  Each piece launches csrc/fused_mlp.cu's kernels on CUDA tensors
and runs its plain twin on CPU tensors, counted apart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from haconvdr_torch.index.quantize import quantize_rows
from haconvdr_torch.ops import _build
from haconvdr_torch.ops.fused_ln import layer_norm

# launches of the CUDA kernels / plain-twin calls: the block, and the three
# pieces of its split mode
COUNTS = {"kernel": 0, "plain": 0, "split_up": 0, "split_down": 0, "split_finish": 0,
          "plain_split_up": 0, "plain_split_down": 0, "plain_split_finish": 0}
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
    return dequant_int32(acc, xs, kernel_scale, bias).reshape(*lead, weight.shape[0])


def dequant_int32(
    acc: torch.Tensor, xs: torch.Tensor, kernel_scale: torch.Tensor, bias: torch.Tensor,
) -> torch.Tensor:
    """``acc`` int32 [M, N] -> float32 ``acc * (xs / 127) * kernel_scale +
    bias``, each step rounded on its own; ``xs`` one scale a row."""
    xs = xs.reshape(-1, 1).to(torch.float32)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which can differ from xs / 127 by one ulp
    xs_127 = xs / torch.full_like(xs, 127.0)
    return acc.to(torch.float32) * xs_127 * kernel_scale + bias


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


# ---------------------------------------------------------------------------
# split mode (a tensor-parallel tower; see the module docstring)
# ---------------------------------------------------------------------------

def _check_split(H: int, I: int) -> None:
    if not fused_mlp_supported(H, I):
        raise ValueError(
            f"split MLP kernels take H % 64 == 0 (<= {MAX_H}) and a rank's I % 64 == 0 "
            f"(<= {MAX_I}); got H={H}, I={I}"
        )


def _cuda(x: torch.Tensor) -> bool:
    """True on a CUDA tensor, False on a CPU one (the plain twin); raises
    on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def split_up_plain(xq, xs, w1, s1, b1) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's up-projection: (g bf16 [rows, I/tp], its row maxima of |g|
    float32 [rows])."""
    COUNTS["plain_split_up"] += 1
    inter = int8_dense(xq, xs, w1, s1, b1).to(torch.bfloat16)
    g = F.gelu(inter, approximate="tanh").reshape(-1, w1.shape[0])
    return g, g.to(torch.float32).abs().amax(dim=-1)


def split_up(xq, xs, w1, s1, b1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split_up_plain``: csrc/fused_mlp.cu's memset and up-projection on
    CUDA (gmax as float32, the kernel's float bits), the twin on the CPU."""
    if not _cuda(xq):
        return split_up_plain(xq, xs, w1, s1, b1)
    I, H = w1.shape
    _check_split(H, I)
    rows = xq.numel() // H
    xq, w1 = xq.contiguous(), w1.contiguous()
    if xq.dtype != torch.int8 or w1.dtype != torch.int8 or xq.data_ptr() % 16 or w1.data_ptr() % 16:
        raise ValueError("xq and w1 must be int8 and 16-byte aligned")
    xs = xs.to(torch.float32).contiguous()
    s1, b1 = s1.to(torch.float32).contiguous(), b1.to(torch.float32).contiguous()
    g = torch.empty((rows, I), dtype=torch.bfloat16, device=xq.device)
    gmax = torch.empty(rows, dtype=torch.int32, device=xq.device)
    lib = _build.library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_fused_mlp_split_up(
            xq.data_ptr(), xs.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            rows, H, I, g.data_ptr(), gmax.data_ptr(), stream,
        )
    _build.check(err, "hc_fused_mlp_split_up")
    COUNTS["split_up"] += 1
    return g, gmax.view(torch.float32)


def split_down_plain(g, gmax, w2, out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's codes of g with the group's row maxima ``gmax`` and its
    raw int32 products with its W2 columns: (part int32 [rows, H], gs
    float32 [rows]); ``out`` receives part when given."""
    COUNTS["plain_split_down"] += 1
    gs = torch.clamp_min(gmax.to(torch.float32), 1e-30)
    gq, _ = quantize_rows(g, gs[:, None])
    part = _int_mm(gq, w2)
    if out is not None:
        out.copy_(part)
        part = out
    return part, gs


def split_down(g, gmax, w2, out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split_down_plain``: csrc/fused_mlp.cu's codes of g and the raw
    down-projection on CUDA, the twin on the CPU."""
    if not _cuda(g):
        return split_down_plain(g, gmax, w2, out)
    H, I = w2.shape
    _check_split(H, I)
    rows = g.shape[0]
    w2 = w2.contiguous()
    if w2.dtype != torch.int8 or w2.data_ptr() % 16 or tuple(g.shape) != (rows, I) \
            or g.dtype != torch.bfloat16 or not g.is_contiguous():
        raise ValueError(f"g must be contiguous bf16 [rows, {I}] and w2 int8 [{H}, {I}], 16-byte aligned")
    gmax = gmax.to(torch.float32).contiguous()
    if out is None:
        out = torch.empty((rows, H), dtype=torch.int32, device=g.device)
    elif out.shape != (rows, H) or out.dtype != torch.int32 or not out.is_contiguous():
        raise ValueError(f"out must be contiguous int32 [{rows}, {H}]")
    gq = torch.empty((rows, I), dtype=torch.int8, device=g.device)
    gs = torch.empty(rows, dtype=torch.float32, device=g.device)
    lib = _build.library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_fused_mlp_split_down(
            g.data_ptr(), gmax.data_ptr(), w2.data_ptr(), rows, H, I, gq.data_ptr(),
            gs.data_ptr(), out.data_ptr(), stream,
        )
    _build.check(err, "hc_fused_mlp_split_down")
    COUNTS["split_down"] += 1
    return out, gs


def split_finish_plain(part, gs, x, s2, b2, ln_scale, ln_bias, eps=1e-12, out_dtype=None):
    """The group's int32 partials ``part`` [tp, rows, H] summed in int32,
    then the block's last steps: (y, yq, ys)."""
    COUNTS["plain_split_finish"] += 1
    acc = part[0]
    for p in part[1:]:
        acc = acc + p
    y2 = dequant_int32(acc, gs, s2, b2).reshape(x.shape)
    y = layer_norm(x + y2.to(x.dtype), ln_scale, ln_bias, eps, out_dtype=out_dtype or x.dtype)
    yq, ys = quantize_rows(y)
    return y, yq, ys


def split_finish(part, gs, x, s2, b2, ln_scale, ln_bias, eps=1e-12, out_dtype=None):
    """``split_finish_plain``: csrc/fused_mlp.cu's int32 sum with the
    dequantization and the residual, then fused_ln.cu's LayerNorm with
    codes, on CUDA; the twin on the CPU."""
    if not _cuda(x):
        return split_finish_plain(part, gs, x, s2, b2, ln_scale, ln_bias, eps, out_dtype)
    out_dtype = out_dtype or x.dtype
    tp, rows, H = part.shape
    if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise ValueError(f"split MLP kernels take a bfloat16 carry; got {x.dtype} -> {out_dtype}")
    if part.dtype != torch.int32 or not part.is_contiguous() or x.numel() != rows * H:
        raise ValueError(f"part must be contiguous int32 [tp, rows, H] over x's {tuple(x.shape)}")
    if H % 64 or not 64 <= H <= MAX_H:
        raise ValueError(f"split MLP kernels take H % 64 == 0 (<= {MAX_H}); got {H}")
    x = x.contiguous()
    vec = [t.to(torch.float32).contiguous() for t in (gs, s2, b2, ln_scale, ln_bias)]
    dev = x.device
    t = torch.empty((rows, H), dtype=torch.bfloat16, device=dev)
    y = torch.empty(x.shape, dtype=out_dtype, device=dev)
    yq = torch.empty(x.shape, dtype=torch.int8, device=dev)
    ys = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_fused_mlp_split_finish(
            part.data_ptr(), tp, vec[0].data_ptr(), x.data_ptr(), vec[1].data_ptr(),
            vec[2].data_ptr(), vec[3].data_ptr(), vec[4].data_ptr(), float(eps), rows, H,
            t.data_ptr(), y.data_ptr(), yq.data_ptr(), ys.data_ptr(), stream,
        )
    _build.check(err, "hc_fused_mlp_split_finish")
    COUNTS["split_finish"] += 1
    return y, yq, ys
