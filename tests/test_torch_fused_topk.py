"""Plain twin of the CUDA fused top-k (haconvdr_torch) against the JAX
reference: the v3 Pallas kernel in interpret mode and exact_topk_oracle.
Inputs are made with numpy and given to both packages.

Tolerances: float32 scores within 1e-5 relative (summation order only);
ids identical.  bfloat16 passages: both sides score exact products of
bfloat16 operands in float32, so the same tolerance holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.ops.pallas_topk import pallas_topk_block
from haconvdr_tpu.ops.topk import exact_topk_oracle as jax_oracle
from haconvdr_torch.ops.fused_topk import (
    decode_keys,
    fused_topk_block,
    fused_topk_block_plain,
    order_keys,
    seed_threshold,
)


def _jax(q, p, n_valid, k, init=None, p_dtype=None):
    pj = jnp.asarray(p, p_dtype) if p_dtype is not None else jnp.asarray(p)
    s, i = pallas_topk_block(
        jnp.asarray(q), pj, jnp.int32(n_valid), k, q_tile=64, p_tile=256,
        init_scores=None if init is None else jnp.asarray(init), interpret=True,
    )
    return np.asarray(s), np.asarray(i)


def _torch(q, p, n_valid, k, init=None, p_dtype=None):
    pt = torch.from_numpy(p)
    if p_dtype is not None:
        pt = pt.to(p_dtype)
    s, i = fused_topk_block(
        torch.from_numpy(q), pt, n_valid, k,
        init_scores=None if init is None else torch.from_numpy(init),
    )
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


def _data(rng, Q, N, D):
    return rng.randn(Q, D).astype(np.float32), rng.randn(N, D).astype(np.float32)


def test_f32_matches_kernel_and_oracle(rng):
    q, p = _data(rng, 40, 1024, 32)
    s, i = _torch(q, p, 1024, 10)
    js, ji = _jax(q, p, 1024, 10)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    np.testing.assert_array_equal(i, ji)
    os_, oi = jax_oracle(jnp.asarray(q), jnp.asarray(p), 10)
    np.testing.assert_array_equal(i, np.asarray(oi))
    np.testing.assert_allclose(s, np.asarray(os_), rtol=1e-5)


def test_n_valid_masks_the_tail(rng):
    q, p = _data(rng, 16, 512, 16)
    p[400:] *= 100.0  # padded rows would win if they surfaced
    s, i = _torch(q, p, 400, 7)
    js, ji = _jax(q, p, 400, 7)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    assert i.max() < 400


def test_seeded_threshold_and_survivors(rng):
    Q, k = 24, 9
    q, p = _data(rng, Q, 512, 16)
    # a running best from an earlier block: its values interleave with
    # this block's top rows, so both seed survivors and block rows appear
    _, extra = _data(rng, 1, 300, 16)
    init = np.sort(q @ extra.T, axis=1)[:, ::-1][:, :k].astype(np.float32).copy()
    s, i = _torch(q, p, 512, k, init=init)
    js, ji = _jax(q, p, 512, k, init=init)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    assert (i == -1).any() and (i >= 0).any()
    # survivors are exactly the seed values that made the merged top k
    full = np.concatenate([init, q @ p.T], axis=1)
    np.testing.assert_allclose(s, -np.sort(-full, axis=1)[:, :k], rtol=1e-5)


def test_k_not_a_multiple_of_128(rng):
    q, p = _data(rng, 8, 768, 24)
    s, i = _torch(q, p, 700, 37)
    js, ji = _jax(q, p, 700, 37)
    assert s.shape == (8, 37)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5)


def test_fewer_rows_than_k(rng):
    q, p = _data(rng, 4, 256, 8)
    s, i = _torch(q, p, 5, 10)
    js, ji = _jax(q, p, 5, 10)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(i[:, 5:], -1)
    assert np.isneginf(s[:, 5:]).all()
    np.testing.assert_allclose(s[:, :5], js[:, :5], rtol=1e-5)


def test_duplicate_rows_tie_to_lower_id(rng):
    q = np.ones((8, 8), np.float32)
    p = np.repeat(rng.randn(32, 8).astype(np.float32), 8, axis=0)  # 8 copies each
    s, i = _torch(q, p, 256, 12)
    os_, oi = jax_oracle(jnp.asarray(q), jnp.asarray(p), 12)
    np.testing.assert_array_equal(i, np.asarray(oi))  # lax.top_k: lowest index wins
    np.testing.assert_allclose(s, np.asarray(os_), rtol=1e-6)
    js, _ = _jax(q, p, 256, 12)
    np.testing.assert_allclose(s, js, rtol=1e-5)


def test_bf16_passages(rng):
    q, p = _data(rng, 16, 512, 32)
    s, i = _torch(q, p, 512, 10, p_dtype=torch.bfloat16)
    js, ji = _jax(q, p, 512, 10, p_dtype=jnp.bfloat16)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-5)
    gap = np.abs(np.diff(js, axis=1)) > 1e-5 * np.abs(js[:, 1:])
    sep = np.concatenate([gap, np.ones((16, 1), bool)], 1) & np.concatenate(
        [np.ones((16, 1), bool), gap], 1
    )
    np.testing.assert_array_equal(i[sep], ji[sep])


def test_keys_roundtrip_and_order():
    s = torch.tensor([[1.5, -0.0, 0.0, float("-inf"), -2.0, 1.5, float("inf")]])
    ids = torch.tensor([[3, 7, 2, -1, 0, 1, 2**31 - 1]])
    keys = order_keys(s, ids)
    ds, di = decode_keys(keys)
    np.testing.assert_array_equal(ds.numpy(), (s + 0.0).numpy())
    np.testing.assert_array_equal(di.numpy(), ids.numpy().astype(np.int32))
    order = torch.argsort(keys, dim=1, descending=True)[0].tolist()
    # (score desc, id asc); -0.0 folds onto +0.0 and ties by id
    assert order == [6, 5, 0, 2, 1, 4, 3]


def test_seed_threshold_is_kth_largest():
    init = torch.tensor([[5.0, 1.0, 3.0], [2.0, 2.0, 0.5]])
    np.testing.assert_array_equal(seed_threshold(init, 3).numpy(), [1.0, 0.5])
    np.testing.assert_array_equal(seed_threshold(init, 2).numpy(), [3.0, 2.0])
    assert torch.isneginf(seed_threshold(init, 4)).all()


def test_plain_twin_chunking_is_invariant(rng):
    from haconvdr_torch.ops.topk import topk_block

    q, p = _data(rng, 6, 1000, 8)
    a = fused_topk_block_plain(torch.from_numpy(q), torch.from_numpy(p), 990, 20)
    b = topk_block(torch.from_numpy(q), torch.from_numpy(p), 990, 20, chunk=7)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-6)


@pytest.mark.parametrize("bad", ["k0", "k129", "int8", "dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    from haconvdr_torch.ops.fused_topk import _check

    q = torch.zeros(2, 8)
    p = torch.zeros(10, 8)
    k, init = 5, None
    if bad == "k0":
        k = 0
    elif bad == "k129":
        k = 129
    elif bad == "int8":
        p = p.to(torch.int8)
    else:
        q = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        _check(q, p, k, init)
