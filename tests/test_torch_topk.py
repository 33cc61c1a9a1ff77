"""Top-k search of the PyTorch port (haconvdr_torch/ops/topk.py) against the
JAX reference (haconvdr_tpu/ops/topk.py): merge tie order, the plain
chunked path, and BlockSearcher over several streamed blocks.  Inputs are
made with numpy and given to both packages.  Float32 scores within 1e-5
relative; ids identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.ops import topk as jtopk
from haconvdr_torch.ops.topk import (
    BlockSearcher,
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
    port = BlockSearcher(top_k=k, passage_chunk=128, query_chunk=8)
    s, i = port.search(q, blocks)
    ref = jtopk.BlockSearcher(top_k=k, passage_chunk=128, use_pallas=False)
    js, ji = ref.search(q, blocks)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5)


def test_block_searcher_with_top_k_and_small_corpus(rng):
    q = rng.randn(4, 8).astype(np.float32)
    blocks = _blocks(rng, [3, 2], 8)
    port = BlockSearcher(top_k=5).with_top_k(9)
    assert port.top_k == 9
    s, i = port.search(q, blocks)
    ref = jtopk.BlockSearcher(top_k=9, passage_chunk=64, use_pallas=False)
    js, ji = ref.search(q, blocks)
    np.testing.assert_array_equal(i, ji)
    assert (i[:, 5:] == -1).all() and np.isneginf(s[:, 5:]).all()
    np.testing.assert_allclose(s[:, :5], js[:, :5], rtol=1e-5)


def test_block_searcher_unported_modes_raise(rng):
    with pytest.raises(NotImplementedError, match="superblock"):
        BlockSearcher(superblock_rows=2048)
    emb = rng.randint(-127, 127, (8, 4)).astype(np.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        BlockSearcher(top_k=2).search(
            np.ones((1, 4), np.float32), [(emb, np.arange(8), np.ones(4, np.float32))]
        )
    with pytest.raises(ValueError, match="int32"):
        BlockSearcher(top_k=2).search(
            np.ones((1, 4), np.float32), [(np.ones((8, 4), np.float32), np.arange(8) + 2**31)]
        )
