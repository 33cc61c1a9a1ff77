"""Plain twin of the CUDA streaming top-k (haconvdr_torch/ops/topk_stream.py)
against the JAX streaming kernel (haconvdr_tpu/ops/pallas_topk_v2.py) in
interpret mode, on the same seeded numpy inputs (the template is
tests/test_pallas_topk.py::test_pallas_v2_stream_matches_oracle).

Tolerance: scores within 1e-5 relative (float32 sums in another order),
plus 1e-6 absolute for scores near 0, where a sum of 32 products of
order 1 keeps only its summation-order noise (a few float32 ulps of the
summands, ~1e-7); ids identical.  bfloat16 passages: both sides score
bfloat16 queries against bfloat16 rows, the products exact in float32,
so the same tolerance holds.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from haconvdr_tpu.ops.pallas_topk_v2 import pallas_topk_block_v2
from haconvdr_torch.ops import topk_stream
from haconvdr_torch.ops.topk_stream import topk_block_v2, topk_block_v2_plain

D, N, P_CHUNK = 32, 1024, 128


def _run_both(q, p, n_valid, k, q_tile, dtype):
    if dtype == "bfloat16":
        q = q.astype(ml_dtypes.bfloat16)
        p = p.astype(ml_dtypes.bfloat16)
    js, ji = pallas_topk_block_v2(
        jnp.asarray(q), jnp.asarray(p), jnp.int32(n_valid), k,
        q_tile=q_tile, p_chunk=P_CHUNK, interpret=True,
    )
    tq, tp = (torch.from_numpy(np.asarray(x, np.float32)) for x in (q, p))
    if dtype == "bfloat16":
        tq, tp = tq.to(torch.bfloat16), tp.to(torch.bfloat16)
    before = dict(topk_stream.COUNTS)
    s, i = topk_block_v2(tq, tp, n_valid, k, q_tile=q_tile, p_chunk=P_CHUNK)
    assert topk_stream.COUNTS == {"kernel": before["kernel"], "plain": before["plain"] + 1}
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "Q, n_valid, k, q_tile",
    [
        (100, 900, 10, 64),  # the JAX test's shapes: two query tiles, masked tail
        (100, 7, 10, 64),  # k > n_valid: empty (-inf, -1) slots
        (20, 1000, 16, 64),  # Q < q_tile
    ],
)
def test_matches_jax_streaming_kernel(rng, dtype, Q, n_valid, k, q_tile):
    q = rng.randn(Q, D).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32)
    p[n_valid:] *= 100.0  # rows past n_valid would win if they surfaced
    s, i, js, ji = _run_both(q, p, n_valid, k, q_tile, dtype)
    assert s.shape == js.shape == (Q, k)
    np.testing.assert_array_equal(i, ji)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], js[fin], rtol=1e-5, atol=1e-6)
    assert i.max() < n_valid
    if k > n_valid:
        assert (i[:, n_valid:] == -1).all() and np.isneginf(s[:, n_valid:]).all()


def test_ties_go_to_the_lower_id():
    q = np.ones((3, D), np.float32)
    p = np.repeat(np.arange(N // 8, dtype=np.float32) % 5, 8)[:, None] * np.ones((1, D), np.float32)
    s, i = topk_block_v2(torch.from_numpy(q), torch.from_numpy(p), N, 30, p_chunk=P_CHUNK)
    for r in range(3):
        row = list(zip((-s[r]).tolist(), i[r].tolist()))
        assert row == sorted(row)


@pytest.mark.parametrize(
    "rows, p_chunk, group, k, match",
    [
        (1000, 128, 2, 10, "multiple of p_chunk \\* group"),  # 1000 % 256
        (1024, 0, 2, 10, "multiple of p_chunk \\* group"),  # default chunk 1024 * 2
        (1024, 128, 2, 129, "k <= 128"),  # past the kernel's KMAX
    ],
)
def test_rejects_what_the_contract_does_not_take(rows, p_chunk, group, k, match):
    q = torch.zeros(4, D)
    p = torch.zeros(rows, D)
    for fn in (topk_block_v2, topk_block_v2_plain):
        with pytest.raises(ValueError, match=match):
            fn(q, p, rows, k, p_chunk=p_chunk, group=group)


def test_default_chunk_follows_the_dtype():
    assert topk_stream.resolve_p_chunk(0, torch.bfloat16) == 2048
    assert topk_stream.resolve_p_chunk(0, torch.float32) == 1024
    assert topk_stream.resolve_p_chunk(256, torch.float32) == 256
    # 4096 rows: a multiple of both defaults' p_chunk * group
    q = torch.randn(5, D)
    for dt in (torch.float32, torch.bfloat16):
        s, i = topk_block_v2(q, torch.randn(4096, D).to(dt), 4000, 8)
        assert s.shape == (5, 8) and int(i.max()) < 4000
