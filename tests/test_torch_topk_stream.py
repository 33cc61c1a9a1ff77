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


def _plant_ties_across_rank_128(rng, Q, n_valid, copies=30, at=115):
    """Nearly parallel queries over random rows, then ``copies`` copies of
    the row they rank ``at``: one tie class from about rank ``at`` to
    ``at + copies`` for every query, across the JAX kernel's 128-lane
    boundary."""
    base = rng.randn(D).astype(np.float32)
    q = (rng.uniform(0.5, 2.0, (Q, 1)) * base + 1e-3 * rng.randn(Q, D)).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32)
    target = np.argsort(-(p[:n_valid] @ base), kind="stable")[at]
    free = rng.permutation(n_valid)
    members = free[free != target][:copies]
    p[members] = p[target]
    return q, p, [np.sort(np.append(members, target))]


@pytest.mark.parametrize("k", [129, 200, 384])
def test_matches_jax_streaming_kernel_above_k_128(k):
    """k > 128, the JAX kernel rounding its buffer up to 256 or 384 lanes
    (pallas_topk_v2.py:160).  Scores as above.  Ids: equal wherever the
    score is unique; a tie class wholly inside the top k holds the same
    members on both sides (JAX orders it by buffer slot, the port by id);
    a class cut by k holds its lowest ids in the port and members of the
    class in JAX (the known tie difference, ROADMAP.md queue 3)."""
    Q, n_valid = 5, N - 24
    q, p, classes = _plant_ties_across_rank_128(np.random.RandomState(k), Q, n_valid)
    s, i, js, ji = _run_both(q, p, n_valid, k, 64, "float32")
    assert s.shape == js.shape == (Q, k)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)
    for r in range(Q):
        assert s[r, 127] == s[r, 128]  # the planted class spans ranks 128 and 129
        for v in np.unique(s[r]):
            at = s[r] == v
            ours, ref = i[r][at], ji[r][js[r] == v]
            if at.sum() == 1:
                assert ours.tolist() == ref.tolist()
                continue
            cls = next(c for c in classes if ours[0] in c)
            assert ours.tolist() == cls[: at.sum()].tolist()  # id asc, lowest ids
            assert set(ref) <= set(cls) and len(ref) == at.sum()
    assert i.max() < n_valid


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
        (1024, 128, 2, 1025, "k <= 1024"),  # past the kernel's STREAM_KMAX
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


# --- the kernel's grid and block shape (pure functions) --------------------

class _SplitQB:
    """A stand-in for the kernels' library: answers hc_topk_split_qb with
    ``qb`` (default: 128 past Q 64, else 64) and records its calls."""

    def __init__(self, qb=None):
        self.qb = qb
        self.calls = []

    def hc_topk_split_qb(self, Q, k, code):
        self.calls.append((Q, k, code))
        return self.qb if self.qb is not None else 128 if Q > 64 else 64


@pytest.mark.parametrize("k", [1, 100, 128, 129, 256, 512, 1024])
@pytest.mark.parametrize("Q", [1, 7, 64, 65, 256])
@pytest.mark.parametrize("rows", [2_498_560, 625_000, 498_712, 53_248, 40_000, 1_000, 1])
def test_stream_plan_covers_the_rows_on_the_v3_grid(k, Q, rows):
    """Each row in one split (splits past the rows, at the end, empty), rows
    a split a multiple of 128, on the v3 kernel's unseeded grid at every k
    (also where k 1,024 leaves a split few rows: at 498,712 rows, the
    probe's shape, 16 k rows a split at least measured 1.04-3.2x slower
    at k 512 and 1,024); the buffers in device memory exactly past k 128."""
    from haconvdr_torch.ops.fused_topk import MAX_WAVES_UNSEEDED, TILE_ROWS, split_geometry

    qb, splits, per, wide = topk_stream.stream_plan(Q, k, rows, 132, torch.float32, _SplitQB())
    assert qb == (128 if Q > 64 else 64) and wide is (k > 128)
    assert per % TILE_ROWS == 0 and splits >= 1
    covered = sum(max(0, min(rows, s * per + per) - s * per) for s in range(splits))
    assert covered == rows
    assert (splits, per) == split_geometry(Q, rows, 132, qb, MAX_WAVES_UNSEEDED)


@pytest.mark.parametrize("Q, k, want", [(256, 100, 66), (256, 129, 66), (256, 1024, 66),
                                        (1, 1024, 132), (1, 100, 132), (64, 512, 132)])
def test_stream_geometry_at_the_smoke_scale(Q, k, want):
    """2,498,560 rows (chip_smoke's row 7): the v3 kernel's one wave of 132
    blocks at every k."""
    _, splits, per, _ = topk_stream.stream_plan(Q, k, 2_498_560, 132, torch.float32, _SplitQB())
    assert splits == want and per * want >= 2_498_560


@pytest.mark.parametrize("dtype, code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_stream_qb_by_k_and_q(dtype, code):
    """Up to k 128 the v3 kernel's QB, asked of the library (one rule for
    the block's shared memory, in csrc/topk_split.cuh); past k 128, where
    the buffers are in device memory, 128 queries a block past Q 64 and 64
    at Q <= 64, without the library."""
    lib = _SplitQB(qb=77)
    plan = topk_stream.stream_plan
    assert plan(65, 101, 4000, 132, dtype, lib)[0] == 77
    assert plan(3, 128, 4000, 132, dtype, lib)[0] == 77
    assert lib.calls == [(65, 101, code), (3, 128, code)]
    assert all(plan(Q, k, 4000, 132, dtype, None)[0] == 128
               for Q in (65, 256) for k in (129, 512, 1024))
    assert all(plan(Q, k, 4000, 132, dtype, None)[0] == 64 for Q in (1, 7, 64) for k in (129, 1024))


@pytest.mark.parametrize("k, device", [(1, False), (128, False), (129, True), (1024, True)])
def test_buffer_placement_by_k(k, device):
    assert topk_stream.stream_plan(256, k, 4000, 132, torch.float32, _SplitQB())[3] is device
