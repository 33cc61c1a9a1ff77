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
    qkv = rng.randn(B, L, 3 * heads * d).astype(np.float32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate(lengths):
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
}


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


def test_kernel_gate():
    assert fused_attention_supported(512, 64, torch.float32)
    assert fused_attention_supported(384, 64, torch.bfloat16)
    assert not fused_attention_supported(513, 64, torch.float32)
    assert not fused_attention_supported(512, 8, torch.float32)
    assert not fused_attention_supported(512, 64, torch.float16)
