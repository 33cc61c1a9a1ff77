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
from haconvdr_torch.ops.fused_attention import fused_attention_qkv_plain

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


def _edge_mask(case, L):
    """[2, L] masks of the edge cases the tensor-core forward's key-tile
    skipping and fragment edges must get right: holes (not a prefix),
    one valid key, and lengths that are not multiples of 16."""
    mask = np.zeros((2, L), np.int32)
    if case == "holes":  # valid keys at 0, 3-5 and 33-47 only
        mask[0, [0, 3, 4, 5, 33, 34, 47]] = 1
        mask[1, 10:] = 1
    elif case == "one_key":
        mask[0, 37] = 1
        mask[1, 0] = 1
    else:  # a full row and a ragged one
        mask[0] = 1
        mask[1, : L // 3] = 1
    return mask


EDGES = [("holes", 48), ("one_key", 64), ("ragged", 77), ("ragged", 130)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case, L", EDGES)
def test_edge_masks_match_jax_interpret(case, L, dtype):
    heads, rate = 2, 0.25
    qkv, _, g = _inputs(2, L, heads, dtype, seed=L + 7)
    mask = _edge_mask(case, L)
    seed = (-123, 456789)
    ref_out, ref_dq = _jax(qkv, mask, g, heads, seed, rate, dtype)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    out = fa.flash_attention(x, torch.from_numpy(mask), heads, seed=seed, drop_rate=rate)
    out.backward(torch.from_numpy(g).to(tdt))
    _close(out.detach().float().numpy(), ref_out, dtype)
    _close(x.grad.float().numpy(), ref_dq, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case, L", [("ragged", 77), ("holes", 48)])
def test_plain_forward_without_dropout_equals_inference_twin(case, L, dtype):
    """At drop rate 0 the trained tower's forward twin and the inference
    twin compute one function bit for bit, so one kernel body serves both."""
    qkv, _, _ = _inputs(2, L, 3, "float32", seed=L)
    x = torch.from_numpy(qkv).to(dtype)
    mask = torch.from_numpy(_edge_mask(case, L))
    a = fa.flash_attention_fwd_plain(x, mask, 3, seed=(1, 2), drop_rate=0.0)
    b = fused_attention_qkv_plain(x, mask, 3)
    assert a.dtype == b.dtype == dtype
    assert torch.equal(a, b)


def _skip_mask(L):
    """[2, L]: valid keys in 0..40 and 100..110 only (key tiles of 16 and 64
    wholly masked between them), and a prefix of 70."""
    mask = np.zeros((2, L), np.int32)
    mask[0, :41] = 1
    mask[0, 100:111] = 1
    mask[1, :70] = 1
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("backend", ["jax", "twin"])
def test_masked_keys_get_zero_gradients_and_do_not_reach_dq(backend, rate, dtype):
    """What the tensor-core backward's key-tile skipping relies on, in the
    reference (the JAX kernel in interpret mode) and in the port's twin:
    where the batch row has a valid key, dK and dV of every masked key are
    exactly 0, and dQ is bit-identical when the masked keys' K and V are
    replaced by other finite values (a masked probability is 0.0f, so its
    dS is 0 and it adds nothing to D or dQ)."""
    L, heads = 128, 2
    H = heads * 64
    qkv, _, g = _inputs(2, L, heads, dtype, seed=31)
    mask = _skip_mask(L)
    seed = (4242, -77)
    other = qkv.copy()
    masked = mask == 0
    noise = np.random.default_rng(5).standard_normal(other.shape).astype(np.float32) * 3
    if dtype == "bfloat16":
        noise = torch.from_numpy(noise).bfloat16().float().numpy()
    for part in (1, 2):  # K, then V
        cols = slice(part * H, (part + 1) * H)
        other[:, :, cols] = np.where(masked[:, :, None], noise[:, :, cols], other[:, :, cols])

    def dqkv(x):
        if backend == "jax":
            return _jax(x, mask, g, heads, seed, rate, dtype)[1]
        tdt = getattr(torch, dtype)
        got = fa.flash_attention_bwd_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(mask),
                                           torch.from_numpy(g).to(tdt), heads, seed, rate)
        return got.float().numpy()

    a, b = dqkv(qkv), dqkv(other)
    for d in (a, b):
        assert not d[:, :, H:][masked].any()  # dK and dV of the masked keys
        assert d[:, :, H:][~masked].any()
    np.testing.assert_array_equal(a[..., :H], b[..., :H])  # dQ, bit for bit


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


# --- why rows 11-12's f32 route needs 3xTF32 products ----------------------


def _tf32(x):
    """RNA rounding of float32 to TF32 (10 mantissa bits), as
    cvt.rna.tf32.f32 (the rounding of tests/test_torch_fused_attention.py)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """a @ b with each operand split x = big + small (both TF32), the three
    products small*big + big*small + big*big summed in float32."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return (as_ @ bb + ab @ bs + ab @ bb).astype(np.float32)


def _mm_tf32(a, b):
    return (_tf32(a) @ _tf32(b)).astype(np.float32)


def _mm_f32(a, b):
    return (a.astype(np.float32) @ b.astype(np.float32)).astype(np.float32)


def _mm_f64(a, b):
    return a.astype(np.float64) @ b.astype(np.float64)


def _flash_head(q, k, v, do, keep, rate, mm):
    """One head of the f32 route's forward and backward with every product
    through ``mm`` (float32 elsewhere, float64 throughout for _mm_f64): O,
    dQ, dK, dV."""
    ft = np.float64 if mm is _mm_f64 else np.float32
    q, k, v, do = (x.astype(ft) for x in (q, k, v, do))
    scale = ft(1.0 / 8.0)
    s = mm(q, k.T).astype(ft) * scale
    e = np.exp(s - s.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    inv = ft(np.float32(1.0 / (1.0 - rate)))
    pt = np.where(keep, p * inv, ft(0)) if rate > 0 else p
    o = mm(pt, v)
    dv = mm(pt.T, do)
    dp = mm(do, v.T).astype(ft)
    if rate > 0:
        dp = np.where(keep, dp * inv, ft(0))
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    return o, mm(ds, k) * scale, mm(ds.T, q) * scale, dv


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("spread", [1.0, 3.0])
def test_3xtf32_products_keep_the_f32_flash_route_within_1e5(spread, rate):
    """The CUDA kernels' f32 route of rows 11-12 forms all seven products
    (S, P V; S again, dPt, dV, dQ, dK) in 3xTF32 on the tensor cores, and
    chip_smoke.py / the card tests hold its output and dqkv to the twins
    within max |diff| 1e-5.  On the card test's data (qkv std 0.5, dO std
    1, L 512, d 64, three heads, the twin's keep mask) a numpy emulation
    with exact TF32 products keeps O, dQ, dK and dV each within 1e-6 of
    float64, as plain float32 products do; with spread 3 (Q and K scaled
    for peaked rows) the float32 softmax alone is ~3e-6 off, and the split
    stays within 1.5x of plain float32's error.  One-term TF32 lands beyond
    1e-5."""
    L, heads = 512, 3
    rng = np.random.default_rng(12)
    qkv = (rng.standard_normal((1, L, 3 * heads * 64)) * 0.5).astype(np.float32)
    qkv[..., : 2 * heads * 64] *= np.float32(spread)
    do = rng.standard_normal((1, L, heads * 64)).astype(np.float32)
    keep = fa._heads_keep((77, -13), 1, heads, L, max(rate, 0.1), "cpu").numpy()[0]
    err3, err1, err32 = np.zeros(4), np.zeros(4), np.zeros(4)
    for h in range(heads):
        cols = [slice(part * heads * 64 + h * 64, part * heads * 64 + (h + 1) * 64)
                for part in range(3)]
        q, k, v = (qkv[0, :, c] for c in cols)
        args = (q, k, v, do[0, :, h * 64:(h + 1) * 64], keep[h], rate)
        ref = _flash_head(*args, _mm_f64)
        for mm, err in ((_mm_3xtf32, err3), (_mm_tf32, err1), (_mm_f32, err32)):
            got = _flash_head(*args, mm)
            err[:] = np.maximum(err, [np.abs(g - r).max() for g, r in zip(got, ref)])
    # O, dQ, dK, dV each
    assert (err3 <= np.maximum(1e-6, 1.5 * err32)).all(), (err3, err32)
    if spread == 1.0:
        assert err3.max() <= 1e-6, err3
    assert err1.max() > 1e-5, err1
