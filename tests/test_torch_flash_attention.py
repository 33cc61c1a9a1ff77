"""The port's trainable attention (haconvdr_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode as
tests/test_flash_attention.py runs it, on the same numpy qkv, mask, seed
words and output cotangent.

Tolerances: float32 output and dqkv within atol 1e-5 + rtol 1e-5 (both
sides sum exact f32 products in another order); bfloat16 within one bf16
ulp of the tensor's largest magnitude (both round P, dS and the outputs to
bf16, and a last-bit difference of a sum can flip one rounding).  The
dropout masks are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.ops.flash_attention import (
    _keep_mask,
    _keep_thresh,
    _seed_for,
    flash_attention_qkv_vjp,
)
from haconvdr_torch.ops import flash_attention as fa

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _inputs(B, L, heads, dtype, seed=0):
    rng = np.random.default_rng(seed)
    H = heads * 64
    qkv = (rng.standard_normal((B, L, 3 * H)) * 0.5).astype(np.float32)
    g = rng.standard_normal((B, L, H)).astype(np.float32)
    lens = L - (L // 8) * np.arange(B)  # ragged padding
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        qkv = torch.from_numpy(qkv).bfloat16().float().numpy()
        g = torch.from_numpy(g).bfloat16().float().numpy()
    return qkv, mask, g


def _jax(qkv, mask, g, heads, seed, rate, dtype):
    jdt = jnp.dtype(dtype)
    q = jnp.asarray(qkv).astype(jdt)
    bias = ((1.0 - jnp.asarray(mask, jnp.float32)) * -1e9)[:, None, :]
    s = jnp.asarray(np.asarray(seed, np.int32))
    out, vjp = jax.vjp(
        lambda x: flash_attention_qkv_vjp(x, bias, s, heads, rate, True), q
    )
    (dq,) = vjp(jnp.asarray(g).astype(jdt))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dq.astype(jnp.float32))


def _close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= ulp, (np.abs(got - ref).max(), ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("L, heads", [(16, 2), (16, 12), (128, 2), (128, 12)])
def test_forward_and_dqkv_match_jax_interpret(L, heads, rate, dtype):
    B = 2
    qkv, mask, g = _inputs(B, L, heads, dtype, seed=L + heads)
    seed = (123456789, -987654321)
    ref_out, ref_dq = _jax(qkv, mask, g, heads, seed, rate, dtype)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    for key in fa.COUNTS:
        fa.COUNTS[key] = 0
    out = fa.flash_attention(x, torch.from_numpy(mask), heads, seed=seed, drop_rate=rate)
    out.backward(torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and x.grad.dtype == tdt
    assert fa.COUNTS == {"fwd": 0, "bwd": 0, "plain_fwd": 1, "plain_bwd": 1}
    _close(out.detach().float().numpy(), ref_out, dtype)
    _close(x.grad.float().numpy(), ref_dq, dtype)


@pytest.mark.parametrize(
    "seed", [(0, 0), (1, 2), (INT32_MAX, INT32_MIN), (INT32_MIN, INT32_MAX), (-1, -1)]
)
def test_keep_mask_equals_jax_bit_for_bit(seed):
    L, heads, rate = 24, 12, 0.1
    thresh = _keep_thresh(rate)
    assert fa.keep_thresh(rate) == thresh
    sj = jnp.asarray(np.asarray(seed, np.int32))
    for b, h in [(0, 0), (1, 5), (3, 11), (170, 7)]:
        j0, j1 = _seed_for(sj, b, h, heads)
        t0, t1 = fa.seed_for(seed, b * heads + h)
        assert int(t0) == int(np.uint32(np.int32(j0))) and int(t1) == int(np.uint32(np.int32(j1)))
        want = np.asarray(_keep_mask(j0, j1, (L, L), thresh))
        np.testing.assert_array_equal(fa.keep_mask(t0, t1, L, thresh).numpy(), want)


def test_mask_drops_the_expected_share():
    keep = fa._heads_keep((5, 6), 2, 3, 64, 0.25, "cpu")
    assert abs(float(keep.float().mean()) - 0.75) < 0.01


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_gradients_pass_gradcheck_in_float64(rate):
    rng = np.random.default_rng(7)
    B, L, heads, d = 2, 6, 2, 8
    qkv = torch.from_numpy(rng.standard_normal((B, L, 3 * heads * d)) * 0.5).requires_grad_(True)
    mask = torch.from_numpy((np.arange(L)[None, :] < np.array([[L], [L - 2]])).astype(np.int32))
    fn = lambda x: fa.flash_attention_plain(x, mask, heads, seed=(11, -3), drop_rate=rate)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (qkv,), eps=1e-6, atol=1e-6)


def test_dropout_off_without_a_seed_and_bad_rates_raise():
    qkv, mask, _ = _inputs(1, 8, 1, "float32")
    x, m = torch.from_numpy(qkv), torch.from_numpy(mask)
    a = fa.flash_attention(x, m, 1, seed=None, drop_rate=0.5)
    b = fa.flash_attention(x, m, 1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="drop_rate"):
        fa.flash_attention(x, m, 1, seed=(1, 2), drop_rate=1.0)


def test_cuda_route_checks_shapes_before_launching():
    x = torch.zeros(1, 8, 3 * 96)
    with pytest.raises(ValueError, match="head dim"):
        fa._check(x, torch.ones(1, 8), 3)
    with pytest.raises(ValueError, match="L <= 512"):
        fa._check(torch.zeros(1, 513, 3 * 64), torch.ones(1, 513), 1)
