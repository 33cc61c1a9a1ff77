"""Differentiable attention with hashed dropout for the trained query tower
(counterpart of haconvdr_tpu/ops/flash_attention.py).

``flash_attention(qkv [B, L, 3H], attention_mask [B, L], num_heads,
seed=None, drop_rate=0.0)`` returns the context ``[B, L, H]`` in qkv's
dtype and is a ``torch.autograd.Function``: on CUDA tensors its forward and
backward are the kernels of csrc/flash_attention.cu, on CPU tensors the
plain twins below, with nothing else in between.  Both dtypes run on the
tensor cores: bfloat16 on mma.sync (csrc/attention_tc.cuh, _bwd.cuh),
float32 in 3xTF32, each product split into three TF32 products
(csrc/attention_tf32.cuh, _bwd.cuh), which keeps the float32 route within
1e-5 of the twins where one TF32 product would not.  A qkv, grad_out or
gradient buffer that is not 16-byte aligned is refused with an error.
``flash_attention_plain`` is the same function through the plain twins on
any device (the reference a kernel run is held against).

Math (the JAX kernels' :105 and :174): per batch row and head, f32 scores
``q k^T / sqrt(d)`` plus the additive ``(1 - mask) * -1e9`` bias, an f32
softmax, attention-probs dropout ``where(keep, p / (1 - rate), 0)``, P cast
to V's dtype before ``P V``.  The backward recomputes the softmax and the
mask, then dV, dP, the softmax VJP, dQ and dK scaled by 1/sqrt(d), in f32,
with P and dS cast to the operand dtype before their products.

Dropout is the JAX package's stateless murmur3 hash (``seed_for``,
``keep_mask``): the element counter ``r * L + c`` of each (b, h) ``[L, L]``
tile, two ``fmix32`` rounds over per-(b, h) seed words, keep iff the hash
is below ``round((1 - rate) * 2^32)``.  The same seed words give the JAX
kernel's mask bit for bit, and the backward regenerates it: no mask is
stored.  The port draws the two int32 seed words of a layer from an
explicit ``torch.Generator`` (``draw_seed``); it cannot reproduce JAX's
threefry keys (``rng_to_seed``), so tests hand both packages the same words.

``row_offset`` (default 0) is the first row's index in the whole batch:
row b of the call draws the mask of tile ``(row_offset + b) * num_heads +
h``.  A data-parallel slot that holds rows a:b of a batch passes
``row_offset=a`` and draws rows a:b of the whole batch's masks (JAX's
kernel takes no offset: its one program sees the whole batch).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from haconvdr_torch.ops import _build

# kernel launches (forward / backward) and calls of the plain twins
COUNTS = {"fwd": 0, "bwd": 0, "plain_fwd": 0, "plain_bwd": 0}
MAX_L = 512
HEAD_DIMS = (64,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_U32 = 0xFFFFFFFF
_MIX0 = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_FMIX_A = 0x85EBCA6B
_FMIX_B = 0xC2B2AE35

Seed = Optional[Sequence[int]]


def keep_thresh(drop_rate: float) -> int:
    """uint32 threshold: keep iff hash < thresh (quantization 2^-32)."""
    return min(2**32 - 1, int(round((1.0 - drop_rate) * 2**32)))


def _to_i32(x: int) -> int:
    x &= _U32
    return x - 2**32 if x >= 2**31 else x


def draw_seed(generator: torch.Generator) -> Tuple[int, int]:
    """Two int32 seed words for one layer's attention dropout."""
    w = torch.randint(-(2**31), 2**31, (2,), generator=generator, dtype=torch.int64)
    return int(w[0]), int(w[1])


def seed_for(seed: Sequence[int], idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(b, h) seed words ``(s0, s1)`` as uint32 values in int64 tensors,
    for the head index ``idx = b * num_heads + h`` (an int64 tensor):
    ``s0 = seed[0] + idx * 0x9E3779B9``, ``s1 = seed[1] ^ ((idx + 1) *
    0x85EBCA6B)``, int32 arithmetic with wrap-around (JAX ``_seed_for``)."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    s0 = (_to_i32(seed[0]) + idx * _MIX0) & _U32
    s1 = (_to_i32(seed[1]) & _U32) ^ (((idx + 1) * _MIX1) & _U32)
    return s0, s1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 values held in int64 (no overflow)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _FMIX_A)
    x = x ^ (x >> 13)
    x = _mul32(x, _FMIX_B)
    return x ^ (x >> 16)


def keep_mask(s0: torch.Tensor, s1: torch.Tensor, L: int, thresh: int) -> torch.Tensor:
    """``[..., L, L]`` boolean keep mask for seed words ``s0, s1`` of shape
    ``[...]`` (JAX ``_keep_mask``): hash of the element counter ``r L + c``."""
    r = torch.arange(L, dtype=torch.int64, device=s0.device)
    idx = r[:, None] * L + r[None, :]
    h = _fmix32(idx ^ s0[..., None, None])
    h = _fmix32(h ^ s1[..., None, None])
    return h < thresh


def _heads_keep(seed: Sequence[int], B: int, nh: int, L: int, drop_rate: float, device,
                row_offset: int = 0):
    """[B, nh, L, L] keep mask of every (b, h) tile, row b being row
    ``row_offset + b`` of the whole batch."""
    idx = torch.arange(row_offset * nh, (row_offset + B) * nh, dtype=torch.int64,
                       device=device).reshape(B, nh)
    s0, s1 = seed_for(seed, idx)
    return keep_mask(s0, s1, L, keep_thresh(drop_rate))


def _plain_parts(qkv, attention_mask, num_heads):
    B, L, H3 = qkv.shape
    H = H3 // 3
    d = H // num_heads
    acc = torch.promote_types(qkv.dtype, torch.float32)

    def heads(t):  # [B, L, H] -> [B, heads, L, d]
        return t.reshape(B, L, num_heads, d).transpose(1, 2).to(acc)

    q, k, v = heads(qkv[..., :H]), heads(qkv[..., H : 2 * H]), heads(qkv[..., 2 * H :])
    scale = 1.0 / math.sqrt(d)
    bias = (1.0 - attention_mask.to(acc)) * -1e9
    s = (q @ k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    return q, k, v, torch.softmax(s, dim=-1), scale, acc, heads


def _drop(x, keep, drop_rate):
    inv = torch.tensor(1.0 / (1.0 - drop_rate), dtype=torch.float32).to(x.dtype)
    return torch.where(keep, x * inv.to(x.device), torch.zeros((), dtype=x.dtype, device=x.device))


def flash_attention_fwd_plain(
    qkv: torch.Tensor, attention_mask: torch.Tensor, num_heads: int,
    seed: Seed = None, drop_rate: float = 0.0, row_offset: int = 0,
) -> torch.Tensor:
    """The forward kernel's math in plain PyTorch (no autograd)."""
    COUNTS["plain_fwd"] += 1
    B, L, H3 = qkv.shape
    _, _, v, p, _, acc, _ = _plain_parts(qkv, attention_mask, num_heads)
    if drop_rate > 0.0:
        keep = _heads_keep(seed, B, num_heads, L, drop_rate, qkv.device, row_offset)
        p = _drop(p, keep, drop_rate)
    o = p.to(qkv.dtype).to(acc) @ v
    return o.transpose(1, 2).reshape(B, L, H3 // 3).to(qkv.dtype)


def flash_attention_bwd_plain(
    qkv: torch.Tensor, attention_mask: torch.Tensor, grad_out: torch.Tensor,
    num_heads: int, seed: Seed = None, drop_rate: float = 0.0, row_offset: int = 0,
) -> torch.Tensor:
    """The backward kernel's math in plain PyTorch: ``dqkv`` [B, L, 3H] in
    qkv's dtype for the output cotangent ``grad_out`` [B, L, H]."""
    COUNTS["plain_bwd"] += 1
    B, L, H3 = qkv.shape
    q, k, v, p, scale, acc, heads = _plain_parts(qkv, attention_mask, num_heads)
    do = heads(grad_out.to(qkv.dtype))
    keep = None
    pt = p
    if drop_rate > 0.0:
        keep = _heads_keep(seed, B, num_heads, L, drop_rate, qkv.device, row_offset)
        pt = _drop(p, keep, drop_rate)
    ptc = pt.to(qkv.dtype).to(acc)
    dv = ptc.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    if keep is not None:
        dp = _drop(dp, keep, drop_rate)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(qkv.dtype).to(acc)
    dq = (dsc @ k) * scale
    dk = (dsc.transpose(-1, -2) @ q) * scale

    def merge(t):  # [B, heads, L, d] -> [B, L, H]
        return t.transpose(1, 2).reshape(B, L, H3 // 3).to(qkv.dtype)

    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)


def _check(qkv: torch.Tensor, attention_mask: torch.Tensor, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [B, L, 3H], got {tuple(qkv.shape)}")
    B, L, H3 = qkv.shape
    H = H3 // 3
    if num_heads <= 0 or H % num_heads:
        raise ValueError(f"hidden {H} not divisible by {num_heads} heads")
    d = H // num_heads
    if not (0 < L <= MAX_L and d in HEAD_DIMS and qkv.dtype in _DTYPE_CODE):
        raise ValueError(
            f"flash attention kernels take L <= {MAX_L}, head dim in {HEAD_DIMS}, "
            f"float32/bfloat16; got L={L}, head dim {d}, {qkv.dtype}"
        )
    if tuple(attention_mask.shape) != (B, L):
        raise ValueError(f"attention_mask must be [{B}, {L}], got {tuple(attention_mask.shape)}")
    if attention_mask.device != qkv.device:
        raise ValueError("qkv and attention_mask must be on one device")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")


def _drop_args(seed: Seed, drop_rate: float, row_offset: int):
    if drop_rate <= 0.0:
        return 0, 0, 0, 0, 1.0, 0
    return (1, _to_i32(seed[0]), _to_i32(seed[1]), keep_thresh(drop_rate),
            1.0 / (1.0 - drop_rate), row_offset)


def _fwd_kernel(qkv, mask, num_heads, seed, drop_rate, row_offset=0):
    """Launch the forward kernel: (out [B, L, H], row stats [B, nh, L, 2])."""
    lib = _build.library()
    B, L, H3 = qkv.shape
    out = torch.empty((B, L, H3 // 3), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, num_heads, L, 2), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_flash_fwd(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), stats.data_ptr(),
            B, L, H3 // 3, num_heads, _DTYPE_CODE[qkv.dtype],
            *_drop_args(seed, drop_rate, row_offset), stream,
        )
    _build.check(err, "hc_flash_fwd")
    COUNTS["fwd"] += 1
    return out, stats


def _bwd_kernel(qkv, mask, stats, grad_out, num_heads, seed, drop_rate, row_offset=0):
    """Launch the backward (its dQ kernel, then its dK / dV kernel)."""
    lib = _build.library()
    B, L, H3 = qkv.shape
    if grad_out.shape != (B, L, H3 // 3):
        raise ValueError(f"grad_out must be [{B}, {L}, {H3 // 3}], got {tuple(grad_out.shape)}")
    dqkv = torch.empty_like(qkv)
    dvec = torch.empty((B, num_heads, L), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_flash_bwd(
            qkv.data_ptr(), mask.data_ptr(), grad_out.data_ptr(), stats.data_ptr(),
            dvec.data_ptr(), dqkv.data_ptr(), B, L, H3 // 3, num_heads,
            _DTYPE_CODE[qkv.dtype], *_drop_args(seed, drop_rate, row_offset), stream,
        )
    _build.check(err, "hc_flash_bwd")
    COUNTS["bwd"] += 1
    return dqkv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, attention_mask, num_heads, seed, drop_rate, row_offset, plain):
        ctx.num_heads, ctx.seed, ctx.drop_rate = num_heads, seed, drop_rate
        ctx.row_offset = row_offset
        ctx.plain = plain or qkv.device.type == "cpu"
        if ctx.plain:
            ctx.save_for_backward(qkv, attention_mask)
            return flash_attention_fwd_plain(qkv, attention_mask, num_heads, seed, drop_rate,
                                             row_offset)
        if qkv.device.type != "cuda":
            raise ValueError(f"unsupported device {qkv.device}")
        _check(qkv, attention_mask, num_heads)
        mask = attention_mask.to(torch.int32).contiguous()
        out, stats = _fwd_kernel(qkv, mask, num_heads, seed, drop_rate, row_offset)
        ctx.save_for_backward(qkv, mask, stats)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        qkv, mask = ctx.saved_tensors[:2]
        g = grad_out.to(qkv.dtype).contiguous()
        if ctx.plain:
            dqkv = flash_attention_bwd_plain(qkv, mask, g, ctx.num_heads, ctx.seed, ctx.drop_rate,
                                             ctx.row_offset)
        else:
            dqkv = _bwd_kernel(qkv, mask, ctx.saved_tensors[2], g, ctx.num_heads, ctx.seed,
                               ctx.drop_rate, ctx.row_offset)
        return dqkv, None, None, None, None, None, None


def _args(seed: Seed, drop_rate: float, row_offset: int):
    if row_offset < 0:
        raise ValueError(f"row_offset must be >= 0, got {row_offset}")
    if drop_rate <= 0.0 or seed is None:
        return None, 0.0
    if not 0.0 < drop_rate < 1.0:
        raise ValueError(f"drop_rate must be in [0, 1), got {drop_rate}")
    return (int(seed[0]), int(seed[1])), float(drop_rate)


def flash_attention(
    qkv: torch.Tensor, attention_mask: torch.Tensor, num_heads: int,
    seed: Seed = None, drop_rate: float = 0.0, row_offset: int = 0,
) -> torch.Tensor:
    """Trainable-tower attention: differentiable in qkv, attention-probs
    dropout fused in the kernels (off when ``seed`` is None or
    ``drop_rate`` is 0), each row's masks those of row ``row_offset + b``
    of the whole batch.  Kernels on CUDA tensors, plain twins on CPU."""
    seed, drop_rate = _args(seed, drop_rate, row_offset)
    return _FlashAttention.apply(qkv, attention_mask, num_heads, seed, drop_rate,
                                 int(row_offset), False)


def flash_attention_plain(
    qkv: torch.Tensor, attention_mask: torch.Tensor, num_heads: int,
    seed: Seed = None, drop_rate: float = 0.0, row_offset: int = 0,
) -> torch.Tensor:
    """``flash_attention`` through the plain twins on any device."""
    seed, drop_rate = _args(seed, drop_rate, row_offset)
    return _FlashAttention.apply(qkv, attention_mask, num_heads, seed, drop_rate,
                                 int(row_offset), True)
