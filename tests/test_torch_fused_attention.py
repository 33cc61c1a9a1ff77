"""Plain twin of the CUDA attention kernel (haconvdr_torch) against the JAX
reference: the Pallas kernel in interpret mode and the encoder's XLA
attention path.  Inputs are made with numpy and given to both packages.

Tolerances: float32 within 1e-5 (summation order only).  bfloat16 outputs
are compared in float32 within one bfloat16 ulp at |x| < 4 (2**-6) plus
2**-8 relative: both sides round P and the output to bfloat16 from float32
values that differ only in summation order, which can move a rounding by
one ulp.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.ops.fused_attention import fused_attention_qkv as jax_fused_qkv
from haconvdr_torch.ops.fused_attention import (
    fused_attention_qkv,
    fused_attention_qkv_plain,
    fused_attention_supported,
)

BF16_ATOL = 2.0**-6
BF16_RTOL = 2.0**-8


def _inputs(rng, B, L, heads, d, lengths):
    """lengths[b]: an int n (the first n keys valid) or a tuple of the
    valid key positions (a mask with holes)."""
    qkv = rng.randn(B, L, 3 * heads * d).astype(np.float32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate(lengths):
        if isinstance(n, tuple):
            mask[b, list(n)] = 1
        else:
            mask[b, :n] = 1
    return qkv, mask


def _xla_attention(qkv, mask, heads):
    """The encoder's non-kernel attention (haconvdr_tpu/models/encoder.py:
    263-279) on the fused projection."""
    B, L, H3 = qkv.shape
    H = H3 // 3
    d = H // heads

    def split(t):
        return t.reshape(B, L, heads, d).transpose(0, 2, 1, 3)

    q, k, v = split(qkv[..., :H]), split(qkv[..., H : 2 * H]), split(qkv[..., 2 * H :])
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    s = s + (1.0 - mask.astype(jnp.float32))[:, None, None, :] * -1e9
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v).transpose(0, 2, 1, 3).reshape(B, L, H)


CASES = {
    "full": ([32, 32], 32),
    "padded": ([20, 7], 32),
    "mostly_padded": ([1, 3], 64),
    # the edges of the tensor-core route's key-tile skipping and fragments
    "holes": ([(0, 3, 4, 5, 70, 71, 90), 50], 96),
    "one_key": ([(37,), (0,)], 64),
    "len77": ([77, 30], 77),
    "len130": ([130, (1, 2, 64, 129)], 130),
}
EDGE_CASES = ["holes", "one_key", "len77", "len130"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_f32(rng, case):
    lengths, L = CASES[case]
    qkv, mask = _inputs(rng, 2, L, 3, 16, lengths)
    ref = np.asarray(jax_fused_qkv(jnp.asarray(qkv), jnp.asarray(mask), 3, interpret=True))
    out = fused_attention_qkv_plain(torch.from_numpy(qkv), torch.from_numpy(mask), 3)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, L, 48)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_xla_attention_f32(rng, case):
    lengths, L = CASES[case]
    qkv, mask = _inputs(rng, 2, L, 4, 8, lengths)
    ref = np.asarray(_xla_attention(jnp.asarray(qkv), jnp.asarray(mask), 4))
    out = fused_attention_qkv(torch.from_numpy(qkv), torch.from_numpy(mask), 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_plain_matches_jax_kernel_bf16(rng):
    qkv, mask = _inputs(rng, 2, 64, 2, 16, [64, 11])
    ref = jax_fused_qkv(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(mask), 2, interpret=True
    )
    assert ref.dtype == jnp.bfloat16
    out = fused_attention_qkv_plain(
        torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(mask), 2
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), rtol=BF16_RTOL, atol=BF16_ATOL
    )


@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_matches_jax_kernel_bf16_edges(rng, case):
    lengths, L = CASES[case]
    qkv, mask = _inputs(rng, 2, L, 2, 64, lengths)
    ref = jax_fused_qkv(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(mask), 2, interpret=True)
    out = fused_attention_qkv_plain(
        torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(mask), 2
    )
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), rtol=BF16_RTOL, atol=BF16_ATOL
    )


def test_kernel_gate():
    assert fused_attention_supported(512, 64, torch.float32)
    assert fused_attention_supported(384, 64, torch.bfloat16)
    assert not fused_attention_supported(513, 64, torch.float32)
    assert not fused_attention_supported(512, 8, torch.float32)
    assert not fused_attention_supported(512, 64, torch.float16)


# --- why the f32 route's 3xTF32 products keep the 1e-4 agreement ---------


def _tf32(x):
    """RNA rounding of float32 to TF32 (10 mantissa bits), as
    cvt.rna.tf32.f32: add half of the 13 dropped bits to the magnitude and
    clear them."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """a @ b with each operand split x = big + small (both TF32) and the
    product big*small + small*big + big*big summed in float32 (each TF32
    product is exact in float32)."""
    ab = _tf32(a)
    as_ = _tf32(a - ab)
    bb = _tf32(b)
    bs = _tf32(b - bb)
    return (as_ @ bb + ab @ bs + ab @ bb).astype(np.float32)


def _mm_tf32(a, b):
    return (_tf32(a) @ _tf32(b)).astype(np.float32)


def _attention_head(q, k, v, mm):
    s = mm(q, k.T) * np.float32(1.0 / 8.0)
    e = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    return mm((e / e.sum(-1, keepdims=True)).astype(np.float32), v)


@pytest.mark.parametrize("spread", [1.0, 3.0])
def test_3xtf32_products_keep_the_f32_route_within_1e4(spread):
    """The CUDA kernel's f32 route forms both products in 3xTF32 on the
    tensor cores, and chip_smoke.py / the card tests hold it to the twin
    within max |diff| 1e-4.  That tolerance is why the split is needed: on
    row 1's f32 data (randn qkv, d 64, L 512; spread 3 scales Q and K for
    peaked softmax rows) a numpy emulation of 3xTF32 stays within 1e-4 of
    the float64 reference, while one-term TF32 (about 3 decimal digits)
    does not."""
    rng = np.random.default_rng(11)
    err3 = err1 = 0.0
    for _ in range(2):  # heads
        q, k, v = (rng.standard_normal((512, 64)).astype(np.float32) for _ in range(3))
        q, k = q * np.float32(spread), k * np.float32(spread)
        s = q.astype(np.float64) @ k.T.astype(np.float64) / 8.0
        p = np.exp(s - s.max(-1, keepdims=True))
        ref = (p / p.sum(-1, keepdims=True)) @ v.astype(np.float64)
        err3 = max(err3, float(np.abs(_attention_head(q, k, v, _mm_3xtf32) - ref).max()))
        err1 = max(err1, float(np.abs(_attention_head(q, k, v, _mm_tf32) - ref).max()))
    assert err3 <= 1e-4, err3
    assert err1 > 1e-4, err1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["padded", "holes"])
def test_head_split_wrapper_matches_jax(rng, dtype, case):
    """fused_attention(q, k, v, mask) over [B, H, L, d] against the JAX
    package's wrapper (fused_attention.py:81-99) in interpret mode, and
    equal bit for bit to fused_attention_qkv of the merged projection."""
    from haconvdr_tpu.ops.fused_attention import fused_attention as jax_fused
    from haconvdr_torch.ops.fused_attention import fused_attention

    lengths, L = CASES[case]
    heads, d = 2, 64
    qkv, mask = _inputs(rng, 2, L, heads, d, lengths)
    q, k, v = (qkv[..., i * heads * d : (i + 1) * heads * d]
               .reshape(2, L, heads, d).transpose(0, 2, 1, 3) for i in range(3))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(t)).to(tdt) for t in (q, k, v))
    got = fused_attention(tq, tk, tv, torch.from_numpy(mask))
    assert got.shape == (2, heads, L, d) and got.dtype == tdt
    merged = fused_attention_qkv(torch.from_numpy(qkv).to(tdt), torch.from_numpy(mask), heads)
    assert torch.equal(got, merged.reshape(2, L, heads, d).transpose(1, 2))
    ref = np.asarray(jax_fused(*(jnp.asarray(t, jnp.dtype(dtype)) for t in (q, k, v)),
                               jnp.asarray(mask), interpret=True).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        diff = np.abs(got.float().numpy() - ref)
        assert (diff <= BF16_ATOL + BF16_RTOL * np.abs(ref)).all()
