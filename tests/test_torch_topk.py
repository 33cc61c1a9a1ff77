"""Top-k search of the PyTorch port (haconvdr_torch/ops/topk.py) against the
JAX reference (haconvdr_tpu/ops/topk.py): merge tie order, the plain
chunked path, and BlockSearcher over several streamed blocks: float and
int8 (codes, ids, scale) blocks, the v4 routing of the first block, and
super-block accumulation in the compute dtype and in int8.  Inputs are
made with numpy and given to both packages.  Float32 scores within 1e-5
relative; ids identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.index.quantize import quantize_int8
from haconvdr_tpu.ops import topk as jtopk
from haconvdr_torch.ops import fused_topk, topk_v4
from haconvdr_torch.ops.topk import (
    BlockSearcher,
    block_topk,
    exact_topk_oracle,
    merge_topk,
    topk_block,
)


def test_merge_topk_running_state_wins_ties():
    a_s = np.array([[3.0, 2.0, 1.0]], np.float32)
    a_i = np.array([[10, 11, 12]], np.int32)
    b_s = np.array([[3.0, 2.0, 2.0]], np.float32)
    b_i = np.array([[1, 2, 3]], np.int32)  # lower ids, but later in the stream
    s, i = merge_topk(*(torch.from_numpy(x) for x in (a_s, a_i, b_s, b_i)), 4)
    js, ji = jtopk.merge_topk(*(jnp.asarray(x) for x in (a_s, a_i, b_s, b_i)), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert i.tolist() == [[10, 1, 11, 2]]


def test_merge_topk_matches_jax_on_random_ties(rng):
    a_s = rng.randint(0, 5, (6, 8)).astype(np.float32)
    b_s = rng.randint(0, 5, (6, 8)).astype(np.float32)
    a_i = rng.permutation(100)[:48].reshape(6, 8).astype(np.int32)
    b_i = rng.permutation(100)[:48].reshape(6, 8).astype(np.int32)
    s, i = merge_topk(*(torch.from_numpy(x) for x in (a_s, a_i, b_s, b_i)), 8)
    js, ji = jtopk.merge_topk(*(jnp.asarray(x) for x in (a_s, a_i, b_s, b_i)), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_topk_block_matches_jax(rng):
    q = rng.randn(12, 16).astype(np.float32)
    p = rng.randn(640, 16).astype(np.float32)
    s, i = topk_block(torch.from_numpy(q), torch.from_numpy(p), 600, 150, chunk=128)
    js, ji = jtopk.topk_block(jnp.asarray(q), jnp.asarray(p), jnp.int32(600), 150, 128)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize(
    "k, seeded, v4, route",
    [(150, False, True, "plain"), (10, False, True, "v4"), (10, True, True, "v3"),
     (10, False, False, "v3")],
)
def test_block_topk_routes_like_jax(rng, k, seeded, v4, route):
    """block_topk, the one router of ShardedIndex and BlockSearcher: k > 128
    takes the plain path, an unseeded v4 block the v4 search, the rest the
    v3 kernel; each route gives the oracle's answer."""
    Q, N, n_valid = 6, 4096, 4000
    q = torch.from_numpy(rng.randn(Q, 16).astype(np.float32))
    p = torch.from_numpy(rng.randn(N, 16).astype(np.float32))
    init = torch.full((Q, k), -1e30) if seeded else None  # below every score
    v4_before, v3_before = dict(topk_v4.COUNTS), fused_topk.COUNTS["plain"]
    s, i = block_topk(q, p, n_valid, k, chunk=512, init_scores=init, v4=v4)
    ran_v4 = topk_v4.COUNTS["plain"] > v4_before["plain"]
    ran_v3 = fused_topk.COUNTS["plain"] > v3_before
    fell_back = topk_v4.COUNTS["v3_fallback"] > v4_before["v3_fallback"]
    want = {"plain": (False, False), "v4": (True, fell_back), "v3": (False, True)}[route]
    assert (ran_v4, ran_v3) == want
    os_, oi = exact_topk_oracle(q, p[:n_valid], k)
    np.testing.assert_array_equal(i.numpy(), oi.numpy())
    np.testing.assert_allclose(s.numpy(), os_.numpy(), rtol=1e-5)


def test_exact_oracle_matches_jax(rng):
    q = rng.randn(5, 8).astype(np.float32)
    p = rng.randn(90, 8).astype(np.float32)
    s, i = exact_topk_oracle(torch.from_numpy(q), torch.from_numpy(p), 7)
    js, ji = jtopk.exact_topk_oracle(jnp.asarray(q), jnp.asarray(p), 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)


def _blocks(rng, sizes, D):
    blocks, base = [], 0
    for n in sizes:
        emb = rng.randn(n, D).astype(np.float32)
        ids = (np.arange(base, base + n, dtype=np.int64) * 3 + 7)
        blocks.append((emb, ids))
        base += n
    return blocks


@pytest.mark.parametrize("k", [11, 150])
def test_block_searcher_streams_blocks_like_jax(rng, k):
    """Three streamed blocks (seeded after the first for k <= 128, plain
    path for k > 128) against JAX BlockSearcher(use_pallas=False)."""
    q = rng.randn(20, 16).astype(np.float32)
    blocks = _blocks(rng, [300, 256, 130], 16)
    port = BlockSearcher(device="cpu", top_k=k, passage_chunk=128, query_chunk=8)
    s, i = port.search(q, blocks)
    ref = jtopk.BlockSearcher(top_k=k, passage_chunk=128, use_pallas=False)
    js, ji = ref.search(q, blocks)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5)


def test_block_searcher_with_top_k_and_small_corpus(rng):
    q = rng.randn(4, 8).astype(np.float32)
    blocks = _blocks(rng, [3, 2], 8)
    port = BlockSearcher(device="cpu", top_k=5).with_top_k(9)
    assert port.top_k == 9
    s, i = port.search(q, blocks)
    ref = jtopk.BlockSearcher(top_k=9, passage_chunk=64, use_pallas=False)
    js, ji = ref.search(q, blocks)
    np.testing.assert_array_equal(i, ji)
    assert (i[:, 5:] == -1).all() and np.isneginf(s[:, 5:]).all()
    np.testing.assert_allclose(s[:, :5], js[:, :5], rtol=1e-5)


def test_block_searcher_rejects_ids_past_int32(rng):
    with pytest.raises(ValueError, match="int32"):
        BlockSearcher(device="cpu", top_k=2).search(
            np.ones((1, 4), np.float32), [(np.ones((8, 4), np.float32), np.arange(8) + 2**31)]
        )
    emb = rng.randint(-127, 127, (8, 4)).astype(np.int8)
    with pytest.raises(ValueError, match="scale"):  # raw codes never score unscaled
        BlockSearcher(device="cpu", top_k=2).search(np.ones((1, 4), np.float32), [(emb, np.arange(8))])
    with pytest.raises(ValueError, match="superblock_rows"):
        BlockSearcher(device="cpu", superblock_dtype="int8")


def _int8_blocks(rng, sizes, D):
    """int8 (codes, ids, scale) blocks, each quantized with its own scale."""
    out = []
    for emb, ids in _blocks(rng, sizes, D):
        codes, scale = quantize_int8(emb)
        out.append((codes, ids, scale))
    return out


@pytest.mark.parametrize("k", [9, 140])
def test_block_searcher_int8_blocks_match_jax(rng, k):
    """int8 blocks fold their scale into the queries and score the
    bfloat16-rounded folded queries against the codes, as the JAX
    package's XLA path does."""
    q = rng.randn(12, 16).astype(np.float32)
    blocks = _int8_blocks(rng, [300, 256, 130], 16)
    s, i = BlockSearcher(device="cpu", top_k=k, query_chunk=8).search(q, blocks)
    ref = jtopk.BlockSearcher(top_k=k, passage_chunk=128, use_pallas=False)
    js, ji = ref.search(q, blocks)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("v4_min_rows", [0, 1_500_000])
def test_block_searcher_superblocks_match_jax(rng, v4_min_rows):
    """f32 super-blocks: three blocks fill a 256-row accumulator twice and
    a partial third time; each fill is searched unseeded (v4 at
    v4_min_rows=0, v3 below the default) and merged."""
    q = rng.randn(10, 16).astype(np.float32)
    blocks = _blocks(rng, [300, 256, 130], 16)
    port = BlockSearcher(device="cpu", top_k=11, superblock_rows=256, v4_min_rows=v4_min_rows)
    before = dict(topk_v4.COUNTS)
    s, i = port.search(q, blocks)
    assert (topk_v4.COUNTS["plain"] > before["plain"]) == (v4_min_rows == 0)
    ref = jtopk.BlockSearcher(
        top_k=11, passage_chunk=128, use_pallas=False, superblock_rows=256
    )
    js, ji = ref.search(q, blocks)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5)


@pytest.mark.parametrize("kind", ["int8", "float"])
def test_block_searcher_int8_superblock_accumulator_matches_jax(rng, kind):
    """The int8 accumulator requantizes every block to the corpus scale
    (the elementwise max of the block scales): int8 blocks by
    scale / corpus scale, float blocks by 1 / corpus scale."""
    q = rng.randn(10, 16).astype(np.float32)
    if kind == "int8":
        blocks = _int8_blocks(rng, [300, 256, 130], 16)
        scale = np.maximum.reduce([b[2] for b in blocks])
    else:
        blocks = _blocks(rng, [300, 256, 130], 16)
        scale = quantize_int8(np.concatenate([b[0] for b in blocks]))[1]
    kw = dict(top_k=7, superblock_rows=256, superblock_dtype="int8", superblock_scale=scale)
    s, i = BlockSearcher(device="cpu", **kw).search(q, blocks)
    js, ji = jtopk.BlockSearcher(passage_chunk=128, use_pallas=False, **kw).search(q, blocks)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="superblock_scale"):
        BlockSearcher(device="cpu", top_k=7, superblock_rows=256, superblock_dtype="int8").search(q, blocks)


def test_block_searcher_first_block_routes_v4(rng, monkeypatch):
    """The unseeded first block goes to the v4 search from v4_min_rows
    rows; later blocks run the seeded v3 kernel (ops/topk.py:383-400 of
    the JAX package)."""
    import haconvdr_torch.ops.topk as ttopk

    calls = []
    real = ttopk.topk_block_v4

    def spy(q, p, nv, k, **kw):
        calls.append(p.shape[0])
        return real(q, p, nv, k, **kw)

    monkeypatch.setattr(ttopk, "topk_block_v4", spy)
    q = rng.randn(6, 16).astype(np.float32)
    blocks = _blocks(rng, [700, 500], 16)
    ref = jtopk.BlockSearcher(top_k=9, passage_chunk=128, use_pallas=False)
    js, ji = ref.search(q, blocks)
    s, i = BlockSearcher(device="cpu", top_k=9, v4_min_rows=600).search(q, blocks)
    assert calls == [700]
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    calls.clear()
    BlockSearcher(device="cpu", top_k=9).search(q, blocks)  # below the default: v3 only
    assert calls == []


def test_sharded_index_kernels_agree(rng):
    """ShardedIndex(kernel="v4") is the default and the v3 kernel its
    alternative (sharded_topk's kernel argument): both exact, same ids."""
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    q = rng.randn(9, 16).astype(np.float32)
    emb = torch.from_numpy(rng.randn(700, 16).astype(np.float32))
    v4i = ShardedIndex.from_tensor(emb)
    v3i = ShardedIndex.from_tensor(emb, kernel="v3")
    assert v4i.kernel == "v4"
    s4, i4 = v4i.search(q, 12)
    s3, i3 = v3i.search(q, 12)
    np.testing.assert_array_equal(i4, i3)
    np.testing.assert_allclose(s4, s3, rtol=1e-6)
    with pytest.raises(ValueError, match="kernel"):
        ShardedIndex(emb, kernel="v2")


def test_sharded_index_int8_matches_jax_above_128(rng):
    """int8 residency for k > 128 scores the bfloat16-rounded folded query
    against the codes, the JAX ShardedIndex's XLA model: same ids."""
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_search import ShardedIndex as JaxIndex
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    q = rng.randn(6, 16).astype(np.float32)
    emb = rng.randn(600, 16).astype(np.float32)
    port = ShardedIndex.from_tensor(torch.from_numpy(emb), dtype="int8")
    s, i = port.search(q, 150)
    # chunk 640 >= 600 rows: the first shard holds every row, so its scale
    # is the whole index's, as in the port's one-shard index
    js, ji = JaxIndex(make_mesh(), emb, chunk=640, dtype="int8").search(q, 150)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)
