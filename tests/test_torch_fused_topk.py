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


@pytest.mark.parametrize("bad", ["k0", "k129", "int16", "dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    from haconvdr_torch.ops.fused_topk import _check

    q = torch.zeros(2, 8)
    p = torch.zeros(10, 8)
    k, init = 5, None
    if bad == "k0":
        k = 0
    elif bad == "k129":
        k = 129
    elif bad == "int16":  # int8 passages are the int8 mode; int16 has none
        p = p.to(torch.int16)
    else:
        q = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        _check(q, p, k, init)


@pytest.mark.parametrize("queries", ["folded", "codes"])
def test_int8_mode_matches_kernel(rng, queries):
    """int8 passages score bfloat16 queries (pallas_topk.py:126-131,
    203-207): folded float queries are rounded to bf16; int8 codes, as v4's
    fallback hands them over, stay exact and score exact integers."""
    from haconvdr_tpu.index.quantize import quantize_int8

    codes, scale = quantize_int8(rng.randn(1024, 32).astype(np.float32))
    q = rng.randn(24, 32).astype(np.float32) * scale
    if queries == "codes":
        q = np.clip(np.round(q / np.abs(q).max(1, keepdims=True) * 127), -127, 127)
        q = q.astype(np.int8)
    s, i = _torch(q, codes, 1000, 10)
    js, ji = _jax(q.astype(np.float32) if queries == "codes" else q, codes, 1000, 10)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)
    if queries == "codes":
        full = q.astype(np.int64) @ codes[:1000].astype(np.int64).T
        np.testing.assert_array_equal(s, -np.sort(-full, axis=1)[:, :10].astype(np.float32))


# --- the split kernel's grid (split_geometry, a pure function) -------------

@pytest.mark.parametrize("rows", [2_499_000, 2_500_000, 625_000, 500_000, 1_000, 128, 1])
@pytest.mark.parametrize("Q", [1, 7, 64, 65, 256, 512, 1000, 1024])
def test_split_geometry_covers_the_rows_in_whole_waves(Q, rows):
    """The splits cover exactly ``rows`` (each row in one split; splits past
    the rows, at the end, are empty), rows a split are a multiple of 128, splits <= 65,535, and the grid
    (query tiles x splits) is a whole number of waves of 132 SMs at one
    block an SM wherever the rows hold enough 128-row tiles."""
    from haconvdr_torch.ops.fused_topk import MAX_SPLITS, TILE_ROWS, split_geometry

    qb = 64 if Q <= 64 else 128
    splits, per = split_geometry(Q, rows, 132, qb)
    assert per % TILE_ROWS == 0 and 1 <= splits <= MAX_SPLITS
    starts = [s * per for s in range(splits)]
    covered = sum(max(0, min(rows, a + per) - a) for a in starts)
    assert covered == rows
    tiles = -(-rows // TILE_ROWS)
    blocks = -(-Q // qb) * splits
    if tiles >= 132:
        assert blocks % 132 == 0
        # every block takes the same number of tiles, but for the last split
        assert per // TILE_ROWS == -(-tiles // splits)
    else:
        assert splits == min(tiles, 132)


@pytest.mark.parametrize("Q, qb, want", [(1, 64, 132), (64, 64, 132), (65, 128, 132),
                                         (256, 128, 66), (512, 128, 33), (1024, 128, 33)])
def test_split_geometry_splits_at_the_reference_scale(Q, qb, want):
    """2,500,000 rows (one block of the reference's index): one wave at Q 1
    to 512, two at 1,024 (8 query tiles)."""
    from haconvdr_torch.ops.fused_topk import split_geometry

    splits, per = split_geometry(Q, 2_500_000, 132, qb)
    assert splits == want and splits * per >= 2_500_000 > (splits - 1) * per


@pytest.mark.parametrize("Q, rows", [(0, 1000), (5, 0), (0, 0), (3, -4)])
def test_split_geometry_empty(Q, rows):
    from haconvdr_torch.ops.fused_topk import TILE_ROWS, split_geometry

    assert split_geometry(Q, rows, 132, 64) == (1, TILE_ROWS)


def test_split_geometry_other_sm_counts():
    """An SM count the query tiles do not divide: the fewest splits that
    make whole waves (132 SMs, 8 tiles: 33 splits; 114 SMs, 3 tiles: 38);
    past two waves' worth of query tiles, one split."""
    from haconvdr_torch.ops.fused_topk import split_geometry

    assert split_geometry(1024, 10_000_000, 132, 128)[0] == 33
    assert split_geometry(384, 10_000_000, 114, 128)[0] == 38
    assert split_geometry(10**6, 10_000_000, 132, 128)[0] == 1  # 7,813 tiles, 60 waves


@pytest.mark.parametrize("Q, qb, want, waves", [
    (640, 128, 26, 1), (513, 128, 26, 1), (896, 128, 37, 2), (769, 128, 37, 2),
    (384, 128, 44, 1), (768, 128, 22, 1), (1024, 64, 8, 1), (961, 64, 8, 1)])
def test_split_geometry_caps_the_waves_where_the_tiles_do_not_divide(Q, qb, want, waves):
    """Query tiles that share no factor with 132 SMs (5 and 7 at Q 513-640
    and 769-896) would take 132 splits and 5-7 waves to fill whole waves;
    the grid stays within two waves at 98% of the SMs or more, and 16 tiles
    (64-query tiles at Q 1,024) within one at 97%.  Q 257-384 and 641-768
    still fill one wave exactly."""
    from haconvdr_torch.ops.fused_topk import TILE_ROWS, split_geometry

    splits, per = split_geometry(Q, 2_500_000, 132, qb)
    blocks = -(-Q // qb) * splits
    assert (splits, -(-blocks // 132)) == (want, waves)
    assert blocks >= 0.969 * 132 * waves
    assert per % TILE_ROWS == 0 and splits * per >= 2_500_000 > (splits - 1) * per


@pytest.mark.parametrize("Q, qb, want, waves", [
    (640, 128, 132, 5), (896, 128, 132, 7), (1024, 64, 33, 4), (256, 128, 66, 1),
    (1024, 128, 33, 2), (10**6, 128, 1, 60)])
def test_split_geometry_seeded_grids_take_whole_waves(Q, qb, want, waves):
    """The seeded cap (MAX_WAVES_SEEDED, eight waves): whole waves wherever
    eight waves allow it, the fewest splits that make them; the same grid
    as the unseeded cap where that one fills whole waves too; one split
    past eight waves' worth of query tiles."""
    from haconvdr_torch.ops.fused_topk import MAX_WAVES_SEEDED, split_geometry

    splits, per = split_geometry(Q, 2_500_000, 132, qb, MAX_WAVES_SEEDED)
    blocks = -(-Q // qb) * splits
    assert (splits, -(-blocks // 132)) == (want, waves)
    assert splits * per >= 2_500_000 > (splits - 1) * per


def _jax_presample(q, p, n_valid, k, presample, p_dtype=None):
    pj = jnp.asarray(p, p_dtype) if p_dtype is not None else jnp.asarray(p)
    s, i = pallas_topk_block(jnp.asarray(q), pj, jnp.int32(n_valid), k, q_tile=64,
                             p_tile=1024, presample=presample, interpret=True)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("presample", [16, 4])
def test_presample_matches_jax_and_the_unseeded_answer(rng, presample, p_dtype):
    """presample (pallas_topk.py:235-279): a per-tile-prefix sample scored
    in one product seeds the kernel with a threshold only.  The answers
    equal the unseeded ones bit for bit, never surface id -1, and agree
    with JAX's presampled kernel in interpret mode (1,024-row tiles)."""
    from haconvdr_torch.ops.fused_topk import presample_threshold

    q, p = _data(rng, 40, 4096, 32)
    n_valid, k = 4000, 12
    tdt = getattr(torch, p_dtype)
    pt, qt = torch.from_numpy(p).to(tdt), torch.from_numpy(q)
    thr = presample_threshold(qt, pt, n_valid, k, presample)
    assert thr is not None and torch.isfinite(thr).all()
    s0, i0 = fused_topk_block(qt, pt, n_valid, k)
    s, i = fused_topk_block(qt, pt, n_valid, k, presample=presample)
    assert torch.equal(s, s0) and torch.equal(i, i0) and (i >= 0).all()
    assert (s[:, -1] > thr).all()  # the threshold sits below every query's k-th score
    js, ji = _jax_presample(q, p, n_valid, k, presample, jnp.dtype(p_dtype))
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-5)


def test_presample_threshold_rule(rng):
    """The threshold is each query's k-th sample score less
    (|vk| + 1) * 1e-5 over rows t * 1024 + j, j < presample, below n_valid;
    auto (presample < 0) takes 16 rows a tile and is off below 2**18 rows;
    a sample smaller than k is off."""
    from haconvdr_torch.ops.fused_topk import presample_threshold

    q = torch.from_numpy(rng.randn(5, 4).astype(np.float32))
    p = torch.from_numpy(rng.randn(5000, 4).astype(np.float32))
    thr = presample_threshold(q, p, 4500, 3, 8)
    rows = np.array([t * 1024 + j for t in range(5) for j in range(8) if t * 1024 + j < 4500])
    s = q.numpy() @ p.numpy()[rows].T
    vk = -np.sort(-s, axis=1)[:, 2]
    np.testing.assert_allclose(thr.numpy(), vk - (np.abs(vk) + 1) * 1e-5, rtol=1e-6)
    assert presample_threshold(q, p, 4500, 3, 0) is None
    assert presample_threshold(q, p, 4500, 3, -1) is None  # auto: under 2**18 rows
    assert presample_threshold(q, p, 4500, 41, 8) is None  # 5 tiles x 8 < k
    big = torch.zeros((1 << 18, 4))
    big[::7] = 1.0
    assert presample_threshold(q, big, 1 << 18, 3, -1) is not None
    s, i = fused_topk_block(q, big, 1 << 18, 3, presample=-1)
    s0, i0 = fused_topk_block(q, big, 1 << 18, 3)
    assert torch.equal(s, s0) and torch.equal(i, i0)
