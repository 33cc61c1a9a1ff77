"""CUDA kernels of the PyTorch port against their plain twins, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the skip is
decided in a fixture, never at import).  On a machine with a card and no
JAX, run them without the JAX-side conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances as in chip_smoke.py: inference attention float32 within 1e-4,
flash attention float32 within 1e-5 (on the edge masks against the twins
run in float64, see _check_f32_flash), bfloat16 within one bf16 ulp;
top-k scores within 1e-4 relative and ids identical (the inputs here
have no near-ties).  int8 x int8 scores are exact
integers: equal, and ids identical at every position.  The rescore
kernel equals the window kernel bit for bit (one arithmetic for both);
the select kernel equals ``select_plain`` bit for bit (an exact
selection), split or in one launch.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture()
def gen(dev):
    return torch.Generator(device=dev).manual_seed(1234)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [512, 77])
def test_attention_kernel_matches_plain(dev, gen, dtype, L):
    from haconvdr_torch.ops import fused_attention as fa

    qkv = torch.randn(3, L, 3 * 768, device=dev, generator=gen).to(dtype)
    mask = torch.ones(3, L, dtype=torch.int64, device=dev)
    mask[1, L // 2 :] = 0
    mask[2, 1:] = 0  # mostly padded
    before = fa.COUNTS["kernel"]
    out = fa.fused_attention_qkv(qkv, mask, 12)
    torch.cuda.synchronize()
    assert fa.COUNTS["kernel"] == before + 1
    ref = fa.fused_attention_qkv_plain(qkv, mask, 12)
    assert out.dtype == dtype and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:
        assert bool((diff <= 2.0**-6 + 2.0**-8 * ref.float().abs()).all())


def test_attention_wrapper_rejects_unsupported(dev):
    from haconvdr_torch.ops.fused_attention import fused_attention_qkv

    with pytest.raises(ValueError):
        fused_attention_qkv(torch.zeros(1, 8, 3 * 64, device=dev), torch.ones(1, 8, device=dev), 8)
    with pytest.raises(ValueError):
        fused_attention_qkv(
            torch.zeros(1, 513, 3 * 768, device=dev), torch.ones(1, 513, device=dev), 12
        )


def _topk_pair(q, p, n_valid, k, init=None):
    from haconvdr_torch.ops import fused_topk as ft

    before = ft.COUNTS["kernel"]
    s, i = ft.fused_topk_block(q, p, n_valid, k, init_scores=init)
    torch.cuda.synchronize()
    assert ft.COUNTS["kernel"] == before + 1
    rs, ri = ft.fused_topk_block_plain(q, p, n_valid, k, init_scores=init)
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(s))
    assert bool(((s[fin] - rs[fin]).abs() <= 1e-4 * rs[fin].abs()).all())
    assert torch.equal(i, ri)
    return s, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [100, 1, 128, 37])
def test_topk_kernel_matches_plain(dev, gen, dtype, k):
    q = torch.randn(70, 768, device=dev, generator=gen)
    p = torch.randn(50_000, 768, device=dev, generator=gen).to(dtype)
    p[49_000:] *= 100.0  # past n_valid: must never surface
    _, i = _topk_pair(q, p, 49_000, k)
    assert int(i.max()) < 49_000


def test_topk_kernel_seeded(dev, gen):
    q = torch.randn(33, 64, device=dev, generator=gen)
    p = torch.randn(20_000, 64, device=dev, generator=gen)
    extra = torch.randn(2_000, 64, device=dev, generator=gen)
    init = torch.topk(q @ extra.T, 50, dim=1).values
    _, i = _topk_pair(q, p, 20_000, 50, init=init)
    assert bool((i == -1).any()) and bool((i >= 0).any())


def test_topk_kernel_small_and_tied(dev):
    q = torch.ones(5, 16, device=dev)
    p = torch.arange(40, device=dev, dtype=torch.float32).repeat_interleave(8)[:, None]
    p = (p % 5).expand(-1, 16).contiguous()  # heavy exact ties
    s, i = _topk_pair(q, p, 300, 30)
    # ties go to the lower id
    for r in range(5):
        row = list(zip((-s[r]).tolist(), i[r].tolist()))
        assert row == sorted(row)
    s, i = _topk_pair(q, p, 7, 20)  # fewer rows than k
    assert bool((i[:, 7:] == -1).all()) and bool(torch.isneginf(s[:, 7:]).all())


# The split kernel's tiles (64 or 128 queries, 128 rows), its filter and its
# candidate lists, on inputs whose scores are exact integers: small integer
# operands, so the fmaf chain and the plain twin's matmul give the same
# floats, and ties are everywhere (the order (score desc, id asc) then
# decides every id).  Every case is held to the twin exactly.

def _int_operands(gen, dev, Q, N, D, dtype, lo=-8, hi=9):
    q = torch.randint(lo, hi, (Q, D), device=dev, generator=gen).float()
    p = torch.randint(lo, hi, (N, D), device=dev, generator=gen)
    return q, p.to(dtype) if dtype != torch.float32 else p.float()


def _topk_exact(q, p, n_valid, k, init=None):
    from haconvdr_torch.ops import fused_topk as ft

    before = ft.COUNTS["kernel"]
    s, i = ft.fused_topk_block(q, p, n_valid, k, init_scores=init)
    torch.cuda.synchronize()
    assert ft.COUNTS["kernel"] == before + 1
    rs, ri = ft.fused_topk_block_plain(q, p, n_valid, k, init_scores=init)
    assert torch.equal(s, rs) and torch.equal(i, ri)
    assert int(i.max()) < n_valid
    return s, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("D", [64, 768])
@pytest.mark.parametrize("Q", [1, 7, 64, 65, 129, 256])
def test_topk_kernel_query_tiles_exact(dev, gen, dtype, D, Q):
    """Each query count (64-query tiles up to Q 64, 128 past it, partial
    tiles), D 64 and 768, n_valid not a multiple of 128 with rows past it
    that would win; f32, bf16 and the int8 mode (bf16 queries)."""
    q, p = _int_operands(gen, dev, Q, 30_000, D, dtype)
    p[29_937:] = 8  # past n_valid: would win every query with a positive sum
    _topk_exact(q, p, 29_937, 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Q", [65, 256])
@pytest.mark.parametrize("k", [1, 37, 100, 128])
def test_topk_kernel_k_exact(dev, gen, dtype, Q, k):
    """k 1 to 128: at k 128 the buffers of 128 queries do not fit beside the
    stages, and the kernel takes 64-query tiles."""
    from haconvdr_torch.ops import _build
    from haconvdr_torch.ops.fused_topk import _DTYPE_CODE

    q, p = _int_operands(gen, dev, Q, 20_000, 768, dtype)
    _topk_exact(q, p, 19_999, k)
    qb = _build.library().hc_topk_split_qb(Q, k, _DTYPE_CODE[dtype])
    assert qb == (64 if k == 128 else 128)


@pytest.mark.parametrize("Q", [1, 129])
def test_topk_kernel_fewer_rows_than_k(dev, gen, Q):
    q, p = _int_operands(gen, dev, Q, 500, 768, torch.float32)
    s, i = _topk_exact(q, p, 90, 100)
    assert bool((i[:, 90:] == -1).all()) and bool(torch.isneginf(s[:, 90:]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_topk_kernel_duplicate_rows_tie_to_lower_id(dev, gen, dtype):
    """Each of 600 rows copied 50 times across the block (other tiles and
    other splits): each tie class comes back whole, in id order."""
    q, base = _int_operands(gen, dev, 129, 600, 768, dtype, -3, 4)
    p = base.repeat(50, 1)
    s, i = _topk_exact(q, p, p.shape[0], 128)
    for r in (0, 64, 128):
        row = list(zip((-s[r]).tolist(), i[r].tolist()))
        assert row == sorted(row) and len(set(s[r].tolist())) < 128


@pytest.mark.parametrize("Q", [7, 129])
def test_topk_kernel_every_score_passes(dev, Q):
    """Scores that rise with the row: every row beats every earlier one, so
    every score of every tile passes the filter (the first tile's 128 x QB
    survivors and every later tile's) and enters its buffer."""
    N, D = 40_000, 64
    p = torch.zeros(N, D, device=dev)
    p[:, 0] = torch.arange(N, device=dev, dtype=torch.float32)
    q = torch.zeros(Q, D, device=dev)
    q[:, 0] = torch.arange(1, Q + 1, device=dev, dtype=torch.float32)
    s, i = _topk_exact(q, p, N - 5, 100)
    assert torch.equal(i[0], torch.arange(N - 6, N - 106, -1, device=dev, dtype=torch.int32))


@pytest.mark.parametrize("Q", [1, 64, 129, 256])
def test_topk_kernel_int8_codes_exact(dev, gen, Q):
    """The int8 mode with int8 codes as queries (v4's fallback): every
    score an exact integer, equal to the plain twin's, ids identical."""
    from haconvdr_torch.index.quantize import quantize_queries_int8

    codes, scale = _int8_index(gen, dev, 30_000, 768)
    q8 = quantize_queries_int8(torch.randn(Q, 768, device=dev, generator=gen) * scale)[0]
    s, _ = _topk_exact(q8, codes, 29_001, 100)
    assert torch.equal(s, s.round())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Q", [7, 129])
def test_topk_kernel_seeded_is_top_k_of_unseeded_and_seed(dev, gen, dtype, Q):
    """The seeded answer equals, key for key, the top k of the unseeded
    answer joined with the seed's entries (id -1)."""
    from haconvdr_torch.ops import fused_topk as ft

    k = 100
    q = torch.randn(Q, 768, device=dev, generator=gen)
    p = torch.randn(50_000, 768, device=dev, generator=gen)
    if dtype == torch.int8:
        from haconvdr_torch.index.quantize import quantize_int8_torch

        p, scale = quantize_int8_torch(p)
        q = q * scale
    else:
        p = p.to(dtype)
    s, i = ft.fused_topk_block(q, p, 49_500, k)
    ref = torch.sort(s.float(), dim=1, descending=True).values
    # a seed interleaving with the block's own top rows, with repeats
    init = torch.cat([ref[:, 5:60:2], ref[:, 5:60:2], ref[:, 50:94] - 1.0], dim=1).contiguous()
    assert init.shape[1] == k  # a threshold: its k-th largest value
    ss, si = ft.fused_topk_block(q, p, 49_500, k, init_scores=init)
    torch.cuda.synchronize()
    minus_one = torch.full((1, 1), -1, dtype=torch.int64, device=dev)
    want = ft.top_keys(torch.cat([ft.order_keys(s, i), ft.order_keys(init, minus_one)], 1), k)
    assert torch.equal(ft.order_keys(ss, si), want)
    assert bool((si == -1).any()) and bool((si >= 0).any())


# --- the streaming top-k (ops/topk_stream.py) ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k, n_valid, Q", [(100, 49_000, 70), (37, 49_000, 70), (128, 53_248, 70),
                                           (10, 5, 70), (1, 49_000, 1), (128, 49_000, 7),
                                           (100, 49_000, 256)])
def test_topk_stream_kernel_matches_plain_and_v3(dev, gen, dtype, k, n_valid, Q):
    """Against its plain twin (scores within 1e-4 relative, plus 1e-4 for
    the near-0 scores that k past n_valid returns; ids identical) and bit
    for bit against the unseeded v3 kernel: both form every score with the
    same fmaf chain."""
    from haconvdr_torch.ops import fused_topk as ft
    from haconvdr_torch.ops import topk_stream as ts

    q = torch.randn(Q, 768, device=dev, generator=gen)
    p = torch.randn(13 * 4096, 768, device=dev, generator=gen).to(dtype)  # p_chunk * group
    p[n_valid:] *= 100.0  # past n_valid: must never surface
    before = dict(ts.COUNTS)
    s, i = ts.topk_block_v2(q, p, n_valid, k)
    torch.cuda.synchronize()
    assert ts.COUNTS == {"kernel": before["kernel"] + 1, "plain": before["plain"]}
    rs, ri = ts.topk_block_v2_plain(q, p, n_valid, k)
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(s))
    assert bool(((s[fin] - rs[fin]).abs() <= 1e-4 * rs[fin].abs() + 1e-4).all())
    assert torch.equal(i, ri)
    vs, vi = ft.fused_topk_block(q, p, n_valid, k)
    assert torch.equal(s, vs) and torch.equal(i, vi)
    if k > n_valid:
        assert bool((i[:, n_valid:] == -1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k, Q", [(129, 70), (256, 70), (1024, 70), (1024, 3), (129, 1),
                                  (512, 7), (512, 256), (1024, 64), (129, 256)])
def test_topk_stream_kernel_above_k_128(dev, gen, dtype, k, Q):
    """k > 128: the buffers in device memory and the wide merge.  Against the
    plain twin as above, with a tie class of 300 equal rows planted for the
    first query across rank 128 (and across k at k 129 and 256: the twin
    keeps the class's lowest ids, and so must the kernel), and rows past
    n_valid that would win."""
    from haconvdr_torch.ops import topk_stream as ts

    n_valid = 49_000
    q = torch.randn(Q, 768, device=dev, generator=gen)
    p = torch.randn(13 * 4096, 768, device=dev, generator=gen)
    ranked = torch.argsort(p[:n_valid] @ q[0], descending=True)
    members = torch.randperm(n_valid, device=dev, generator=gen)[:300]
    p[members] = p[ranked[min(k, 200) - 100]].clone()
    p = p.to(dtype)
    p[n_valid:] *= 100.0
    before = dict(ts.COUNTS)
    s, i = ts.topk_block_v2(q, p, n_valid, k)
    torch.cuda.synchronize()
    assert ts.COUNTS == {"kernel": before["kernel"] + 1, "plain": before["plain"]}
    rs, ri = ts.topk_block_v2_plain(q, p, n_valid, k)
    assert bool(((s - rs).abs() <= 1e-4 * rs.abs() + 1e-4).all())
    # deep in the ranking neighbours come within rounding of each other, and
    # the twin's matmul rounds in another order: ids where the scores are
    # separated (chip_smoke.separated), and the tie class whole
    d = rs.double()
    gap = (d[:, :-1] - d[:, 1:]).abs() > 1e-5 * d[:, 1:].abs()
    ones = torch.ones_like(gap[:, :1])
    sep = torch.cat([ones, gap], 1) & torch.cat([gap, ones], 1)
    assert torch.equal(i[sep], ri[sep])
    def tie_class(scores, ids):  # the ids of the most repeated score
        vals, counts = torch.unique(scores, return_counts=True)
        return ids[scores == vals[counts.argmax()]]

    tie = tie_class(s[0], i[0])
    assert tie.numel() > 1 and torch.equal(tie, tie_class(rs[0], ri[0]))
    assert bool((tie[1:] > tie[:-1]).all())  # ties in id order
    assert int(i.max()) < n_valid and bool((s[:, :-1] >= s[:, 1:]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q", [1, 7, 64, 256])
@pytest.mark.parametrize("k", [1, 128, 129, 512, 1024])
def test_topk_stream_kernel_exact_on_integer_ties(dev, gen, dtype, Q, k):
    """Integer-valued operands in [-3, 3], so every score is an exact
    integer on both sides and ties are everywhere: the (score desc, id asc)
    order decides every id.  Equal to the plain twin at every position; at
    k <= 128 also to the unseeded v3 kernel; rows past n_valid would win."""
    from haconvdr_torch.ops import fused_topk as ft
    from haconvdr_torch.ops import topk_stream as ts

    n_valid = 40_000 - 77
    q, p = _int_operands(gen, dev, Q, 40_960, 64, dtype, -3, 4)
    p[n_valid:] = 3
    s, i = ts.topk_block_v2(q, p, n_valid, k)
    torch.cuda.synchronize()
    rs, ri = ts.topk_block_v2_plain(q, p, n_valid, k)
    assert torch.equal(s, rs) and torch.equal(i, ri)
    assert int(i.max()) < n_valid
    if k <= 128:
        vs, vi = ft.fused_topk_block(q, p, n_valid, k)
        assert torch.equal(s, vs) and torch.equal(i, vi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_stream_qb_fits_the_kernel(dev, gen, dtype):
    """ops/topk_stream.stream_plan picks QBs the kernel takes at every k
    where it changes (the kernel refuses a QB whose shared memory does not
    fit): up to k 128 the v3 kernel's (hc_topk_split_qb), 128 queries a
    block refused where that picks 64; past k 128, 128 past Q 64."""
    from haconvdr_torch.ops import _build
    from haconvdr_torch.ops import topk_stream as ts

    q, p = _int_operands(gen, dev, 65, 4096, 64, dtype, -3, 4)
    for k in (100, 101, 102, 113, 114, 128, 129, 1024):
        s, i = ts.topk_block_v2(q, p, 4000, k)
        torch.cuda.synchronize()
        rs, ri = ts.topk_block_v2_plain(q, p, 4000, k)
        assert torch.equal(s, rs) and torch.equal(i, ri), k
    lib = _build.library()
    code = ts._DTYPE_CODE[dtype]
    qp = q.to(dtype)
    last_k_at_128 = {torch.float32: 101, torch.bfloat16: 113}[dtype]
    qb = {k: ts.stream_plan(65, k, 4000, 132, dtype, lib)[0] for k in (last_k_at_128, 129)}
    assert qb == {last_k_at_128: 128, 129: 128}
    for k in (last_k_at_128 + 1, 128):
        assert ts.stream_plan(65, k, 4000, 132, dtype, lib)[0] == 64
        cand = torch.empty((1, 65, k), dtype=torch.int64, device=dev)
        err = lib.hc_topk_stream(qp.data_ptr(), p.data_ptr(), 65, 4096, 64, 4000, k, 128, 4096,
                                 1, cand.data_ptr(), None, code,
                                 torch.cuda.current_stream().cuda_stream)
        assert err != 0, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [100, 1024])
def test_topk_stream_kernel_unaligned_rows(dev, gen, dtype, k):
    """Rows of odd width (77) and a passage view one element off a 16-byte
    boundary take the split body's narrow loads: the same bits as the
    aligned rows give, and the plain twin's answer on integer operands."""
    from haconvdr_torch.ops import topk_stream as ts

    q, _ = _int_operands(gen, dev, 70, 1, 77, dtype, -3, 4)
    base = torch.randint(-3, 4, (4096 * 77 + 1,), device=dev, generator=gen).to(dtype)
    p = base[1:].view(4096, 77)  # one element past the allocation
    assert p.data_ptr() % 16 != 0 and p.is_contiguous()
    aligned = p.clone()
    s, i = ts.topk_block_v2(q, p, 4000, k)
    torch.cuda.synchronize()
    sa, ia = ts.topk_block_v2(q, aligned, 4000, k)
    assert torch.equal(_bits(s), _bits(sa)) and torch.equal(i, ia)
    rs, ri = ts.topk_block_v2_plain(q, p, 4000, k)
    assert torch.equal(s, rs) and torch.equal(i, ri)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("Q", [1, 64, 256])
def test_v3_kernel_is_the_exact_top_k_of_the_fmaf_chain(dev, gen, dtype, seeded, Q):
    """Row 2's scores and ids on random rows are the exact top k, by (score
    desc, id asc), of every row's fmaf chain as the rescore kernel computes
    it (the same conversions and order): one chain and one total order give
    one answer, so the split body's move into csrc/topk_split.cuh left row
    2's bits as they were.  Seeded: the seed's entries join with id -1."""
    from haconvdr_torch.ops import fused_topk as ft
    from haconvdr_torch.ops import topk_v4 as v4

    N, n_valid, k, sw = 30_720, 30_001, 100, 256
    q = torch.randn(Q, 768, device=dev, generator=gen).to(dtype)
    p = torch.randn(N, 768, device=dev, generator=gen).to(dtype)
    init = None
    if seeded:
        extra = torch.randn(500, 768, device=dev, generator=gen)
        init = torch.topk(q.float() @ extra.T, k, dim=1).values.contiguous()
    s, i = ft.fused_topk_block(q, p, n_valid, k, init_scores=init)
    W = N // sw
    win = torch.arange(W, device=dev, dtype=torch.int32)[None, :].expand(Q, -1).contiguous()
    chain = v4.rescore_windows(p, q, win, sw, n_valid)  # [Q, N]: every row's chain
    rows = torch.arange(N, device=dev)[None, :]
    keys = ft.order_keys(chain, rows).masked_fill(rows >= n_valid, torch.iinfo(torch.int64).min)
    if seeded:
        minus_one = torch.full((1, 1), -1, dtype=torch.int64, device=dev)
        thr = ft.seed_threshold(init, k)
        keys = keys.masked_fill(~(chain > thr[:, None]), torch.iinfo(torch.int64).min)
        keys = torch.cat([keys, ft.order_keys(init, minus_one)], 1)
    want_s, want_i = ft.decode_keys(ft.top_keys(keys, k))
    torch.cuda.synchronize()
    assert torch.equal(s.view(torch.int32), want_s.view(torch.int32)) and torch.equal(i, want_i)


def test_topk_stream_rejects_unsupported(dev):
    from haconvdr_torch.ops.topk_stream import topk_block_v2

    q = torch.zeros(4, 768, device=dev)
    with pytest.raises(ValueError, match="k <= 1024"):
        topk_block_v2(q, torch.zeros(2048, 768, device=dev), 2048, 1025)
    with pytest.raises(ValueError, match="p_chunk"):
        topk_block_v2(q, torch.zeros(2000, 768, device=dev), 2000, 10)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        topk_block_v2(q, torch.zeros(2048, 768, device=dev, dtype=torch.int8), 2048, 10)


# --- the v3 kernel's int8 mode and the v4 kernels (ops/topk_v4.py) --------

def _int8_index(gen, dev, N, D):
    from haconvdr_torch.index.quantize import quantize_int8_torch

    return quantize_int8_torch(torch.randn(N, D, device=dev, generator=gen))


@pytest.mark.parametrize("queries", ["folded", "codes"])
def test_topk_kernel_int8_mode(dev, gen, queries):
    from haconvdr_torch.index.quantize import quantize_queries_int8

    codes, scale = _int8_index(gen, dev, 30_000, 768)
    q = torch.randn(40, 768, device=dev, generator=gen) * scale
    if queries == "codes":  # v4's fallback: int8 codes, exact integer scores
        q = quantize_queries_int8(q)[0]
    _topk_pair(q, codes, 29_000, 100)
    extra = torch.randn(500, 768, device=dev, generator=gen)
    init = torch.topk(q.float() @ extra.T, 100, dim=1).values
    _topk_pair(q, codes, 29_000, 100, init=init)


def _v4_inputs(gen, dev, dtype, Q=70, N=50_000, D=768):
    from haconvdr_torch.index.quantize import quantize_queries_int8

    q = torch.randn(Q, D, device=dev, generator=gen)
    if dtype == torch.int8:
        p, scale = _int8_index(gen, dev, N, D)
        return quantize_queries_int8(q * scale)[0], p
    return q.to(dtype), torch.randn(N, D, device=dev, generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_window_top2_matches_plain(dev, gen, dtype):
    from haconvdr_torch.ops import topk_v4 as v4

    q, p = _v4_inputs(gen, dev, dtype)
    before = v4.COUNTS["window"]
    v1, a1, v2 = v4.window_top2(q, p, 49_000, 256)
    torch.cuda.synchronize()
    assert v4.COUNTS["window"] == before + 1
    r1, ra, r2 = v4.window_top2_plain(q, p, 49_000, 256)
    assert torch.equal(torch.isfinite(v1), torch.isfinite(r1))
    assert torch.equal(torch.isfinite(v2), torch.isfinite(r2))
    fin = torch.isfinite(r1)
    tol = 0.0 if dtype == torch.int8 else 1e-4
    for got, ref in ((v1, r1), (v2, r2)):
        f = torch.isfinite(ref)
        assert bool(((got[f] - ref[f]).abs() <= tol * ref[f].abs()).all())
    gap = (r1 - r2) > (0.0 if dtype == torch.int8 else 1e-5) * r1.abs()
    assert torch.equal(a1[fin & gap], ra[fin & gap])
    assert bool(torch.isneginf(v1[49_000 // 256 + 1 :]).all())  # past n_valid


# the window kernel's routes by dtype (ops/topk_v4.window_route)
WINDOW_ROUTES = {torch.float32: ("a", "b"), torch.bfloat16: ("a", "b"), torch.int8: ("a", "c")}
WINDOW_QS = [1, 7, 16, 17, 64, 70, 129, 256]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize(
    "Q, route",
    [(70, None), (1, "a"), (16, "a"), (64, "a"), (64, "tiled"), (256, "tiled"), (1, "tiled")],
)
@pytest.mark.parametrize("sw, B", [(256, 8), (128, 4), (256, 6)])  # (256, 6): the int8 budget
def test_rescore_equals_window_kernel_bit_for_bit(dev, gen, dtype, Q, route, sw, B):
    from haconvdr_torch.ops import topk_v4 as v4

    q, p = _v4_inputs(gen, dev, dtype, Q=Q)
    if route == "tiled":
        route = WINDOW_ROUTES[dtype][1]
    v1, a1, v2 = v4.window_top2(q, p, 49_000, sw, route=route)
    W = v1.shape[0]
    win = torch.randint(0, W, (q.shape[0], B), device=dev, generator=gen, dtype=torch.int32)
    win[:, -1] = -1  # an empty slot
    resc = v4.rescore_windows(p, q, win, sw, 49_000).view(q.shape[0], B, sw)
    ref = v4.rescore_windows_plain(p, q, win, sw, 49_000).view(q.shape[0], B, sw)
    assert bool(torch.isneginf(resc[:, -1]).all())
    f = torch.isfinite(ref)
    assert torch.equal(f, torch.isfinite(resc))
    # summation order only: rows score near 0 as often as not, hence the atol
    assert bool(((resc[f] - ref[f]).abs() <= 1e-4 * ref[f].abs() + 1e-4).all())
    qi = torch.arange(q.shape[0], device=dev)[:, None].expand(-1, B - 1)
    w = win[:, : B - 1].long()
    assert torch.equal(resc[:, : B - 1].amax(2), v1[w, qi])
    pos = a1[w, qi].long() - w * sw
    masked = resc[:, : B - 1].scatter(2, pos[..., None], float("-inf"))
    assert torch.equal(masked.amax(2), v2[w, qi])


def _assert_rescore_matches_window(resc, win, v1, a1, v2, sw):
    """resc [Q, B, sw] of rescore_windows on win [Q, B]: on every slot that
    names a window, its max, that max's lowest row and the second max equal
    the window kernel's (v1, a1, v2) [W, Q] bit for bit."""
    Q, B = win.shape
    live = win >= 0
    w = win.clamp(min=0).long()
    qi = torch.arange(Q, device=win.device)[:, None].expand(-1, B)
    top = resc.amax(2)
    assert torch.equal(_bits(top[live]), _bits(v1[w, qi][live]))
    lane = torch.arange(sw, device=win.device)
    pos = torch.where(resc == top[..., None], lane, sw).amin(2)
    fin = live & torch.isfinite(top)
    assert torch.equal((pos + w * sw)[fin], a1[w, qi].long()[fin])
    second = resc.scatter(2, pos.clamp(max=sw - 1)[..., None], float("-inf")).amax(2)
    assert torch.equal(_bits(second[fin]), _bits(v2[w, qi][fin]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Q", [1, 8, 33])
@pytest.mark.parametrize("sw", [64, 128, 256, 96])
def test_rescore_kernel_edges(dev, gen, dtype, Q, sw):
    """The rescore kernel (16-row pieces, one row a lane) at an n_valid
    inside one slot's window (the window straddles it: rows before it
    score, rows from it -inf), a window wholly past it, and a query whose
    slots are all -1 (all -inf, nothing read), against its plain twin and
    the window kernel's (route A) triples bit for bit; sw 96 is no multiple
    of the window kernel's rows and is held to the twin only."""
    from haconvdr_torch.ops import topk_v4 as v4

    N = 20_000
    W = -(-N // sw)
    n_valid = (W - 2) * sw + sw // 3 + 1  # inside window W - 2; window W - 1 wholly past it
    q, p = _v4_inputs(gen, dev, dtype, Q=Q, N=N)
    B = 6
    win = torch.randint(0, W, (Q, B), device=dev, generator=gen, dtype=torch.int32)
    win[:, 0] = W - 2  # straddles n_valid
    win[:, 1] = W - 1  # wholly past n_valid
    win[:, -1] = -1
    win[-1] = -1  # every slot empty
    resc = v4.rescore_windows(p, q, win, sw, n_valid).view(Q, B, sw)
    torch.cuda.synchronize()
    ref = v4.rescore_windows_plain(p, q, win, sw, n_valid).view(Q, B, sw)
    f = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(resc), f)
    # summation order only: rows score near 0 as often as not, hence the atol
    assert bool(((resc[f] - ref[f]).abs() <= 1e-4 * ref[f].abs() + 1e-4).all())
    assert bool(torch.isneginf(resc[-1]).all()) and bool(torch.isneginf(resc[:, 1]).all())
    straddle = resc[:-1, 0]
    cut = n_valid - (W - 2) * sw
    assert bool(torch.isfinite(straddle[:, :cut]).all())
    assert bool(torch.isneginf(straddle[:, cut:]).all())
    if sw % 64 == 0:  # the window kernel's windows
        v1, a1, v2 = v4.window_top2(q, p, n_valid, sw, route="a")
        _assert_rescore_matches_window(resc, win, v1, a1, v2, sw)


def test_rescore_rejects_unsupported(dev):
    from haconvdr_torch.ops import topk_v4 as v4

    q = torch.zeros(2, 64, device=dev)
    p = torch.zeros(1024, 64, device=dev)
    win = torch.zeros(2, 4, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="win_ids must be"):
        v4.rescore_windows(p, q, win.long(), 128, 1024)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _window_case(gen, dev, dtype, N, sw, D=768, Q=256):
    """Queries, passages of N rows with exact ties inside windows (each
    fifth row repeats the row before it), and an n_valid inside the
    next-to-last window, so that the last window lies wholly past it."""
    from haconvdr_torch.index.quantize import quantize_queries_int8

    W = -(-N // sw)
    n_valid = (W - 2) * sw + sw // 2 + 3
    q = torch.randn(Q, D, device=dev, generator=gen)
    p = torch.randn(N, D, device=dev, generator=gen)
    p[5::5] = p[4:-1:5][: p[5::5].shape[0]]
    if dtype == torch.int8:
        p, scale = _int8_index(gen, dev, N, D)
        p[5::5] = p[4:-1:5][: p[5::5].shape[0]]
        return quantize_queries_int8(q * scale)[0], p, n_valid
    return q.to(dtype), p.to(dtype), n_valid


@pytest.mark.parametrize("sw", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_window_routes_are_bit_identical(dev, gen, dtype, sw):
    """Every route of the window kernel at Q 1 .. 256, at an N that is no
    multiple of a tile, n_valid inside a window, a window wholly past it
    and tied rows: the panels of all routes bit for bit alike, equal to
    rescore_windows' rows bit for bit (max, its lowest row, the second
    max) and to the plain twin within the window tolerance."""
    from haconvdr_torch.ops import topk_v4 as v4

    N = 20_037
    q_all, p, n_valid = _window_case(gen, dev, dtype, N, sw)
    W = -(-N // sw)
    exact = dtype == torch.int8
    for Q in WINDOW_QS:
        q = q_all[:Q].contiguous()
        panels = {}
        for route in WINDOW_ROUTES[dtype]:
            before = v4.COUNTS["window_" + route]
            panels[route] = v4.window_top2(q, p, n_valid, sw, route=route)
            torch.cuda.synchronize()
            assert v4.COUNTS["window_" + route] == before + 1
        (v1, a1, v2), (w1, b1, w2) = panels.values()
        assert torch.equal(_bits(v1), _bits(w1)) and torch.equal(a1, b1)
        assert torch.equal(_bits(v2), _bits(w2)), (Q, sw)
        assert bool(torch.isneginf(v1[-1]).all()) and bool((a1[-1] == (W - 1) * sw).all())
        r1, ra, r2 = v4.window_top2_plain(q, p, n_valid, sw)
        for got, ref in ((v1, r1), (v2, r2)):
            assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
            f = torch.isfinite(ref)
            assert bool(((got[f] - ref[f]).abs() <= (0.0 if exact else 1e-4) * ref[f].abs()).all())
        gap = torch.isfinite(r1) & ((r1 - r2) > (0.0 if exact else 1e-5) * r1.abs())
        assert torch.equal(a1[gap], ra[gap])
        # the kernel's own rows: rescore every query's last three windows and
        # five random ones
        B = 8
        win = torch.randint(0, W, (Q, B), device=dev, generator=gen, dtype=torch.int32)
        win[:, :3] = torch.arange(W - 3, W, device=dev, dtype=torch.int32)
        resc = v4.rescore_windows(p, q, win, sw, n_valid).view(Q, B, sw)
        qi = torch.arange(Q, device=dev)[:, None].expand(-1, B)
        w = win.long()
        top = resc.amax(2)
        assert torch.equal(_bits(top), _bits(v1[w, qi]))
        lane = torch.arange(sw, device=dev)
        pos = torch.where(resc == top[..., None], lane, sw).amin(2)
        assert torch.equal(pos + w * sw, a1[w, qi].long())
        second = resc.scatter(2, pos[..., None], float("-inf")).amax(2)
        assert torch.equal(_bits(second), _bits(v2[w, qi]))


def test_window_route_refusals(dev):
    from haconvdr_torch.ops import topk_v4 as v4

    q = torch.zeros(4, 768, device=dev)
    p = torch.zeros(1024, 768, device=dev)
    with pytest.raises(ValueError, match="route 'c'"):
        v4.window_top2(q, p, 1024, 256, route="c")
    with pytest.raises(ValueError, match="route 'b'"):
        v4.window_top2(q.to(torch.int8), p.to(torch.int8), 1024, 256, route="b")
    with pytest.raises(ValueError, match="too wide"):
        v4.window_top2(torch.zeros(16, 4096, device=dev), torch.zeros(256, 4096, device=dev),
                       256, 256, route="a")
    assert v4.window_route(1, torch.float32, 4096) == "a"
    assert v4.window_route(16, torch.float32, 4096) == "b"


def test_window_kernel_unaligned_rows(dev, gen):
    """Rows of odd bf16 width and a passage view 2 bytes off a 16-byte
    boundary take the kernel's 2-byte staging: the same bits as the
    aligned rows give, on every route, and in the rescore kernel too."""
    from haconvdr_torch.ops import topk_v4 as v4

    q = torch.randn(20, 77, device=dev, generator=gen).to(torch.bfloat16)
    base = torch.randn(5_001 * 77 + 1, device=dev, generator=gen).to(torch.bfloat16)
    p = base[1:].view(5_001, 77)  # 2 bytes past the allocation
    assert p.data_ptr() % 16 == 2
    aligned = p.clone()
    for route in WINDOW_ROUTES[torch.bfloat16]:
        for Q in (1, 20):
            got = v4.window_top2(q[:Q].contiguous(), p, 4_900, 128, route=route)
            want = v4.window_top2(q[:Q].contiguous(), aligned, 4_900, 128, route=route)
            torch.cuda.synchronize()
            assert all(torch.equal(_bits(a) if a.dtype == torch.float32 else a,
                                   _bits(b) if b.dtype == torch.float32 else b)
                       for a, b in zip(got, want))
            r1, _, _ = v4.window_top2_plain(q[:Q], p, 4_900, 128)
            f = torch.isfinite(r1)
            assert bool(((got[0][f] - r1[f]).abs() <= 1e-4 * r1[f].abs()).all())
    # the rescore kernel on the same rows (2-byte row loads, scalar query
    # loads): the aligned rows' bits, and the window kernel's triples, with a
    # window straddling n_valid and an empty slot
    win = torch.randint(0, 38, (20, 4), device=dev, generator=gen, dtype=torch.int32)
    win[:, 0] = 38  # rows 4,864-4,991: n_valid 4,900 inside it
    win[:, -1] = -1
    v1, a1, v2 = v4.window_top2(q, aligned, 4_900, 128, route="a")
    for Q in (1, 20):
        qq, w = q[:Q].contiguous(), win[:Q].contiguous()
        got = v4.rescore_windows(p, qq, w, 128, 4_900)
        want = v4.rescore_windows(aligned, qq, w, 128, 4_900)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want))
        _assert_rescore_matches_window(got.view(Q, 4, 128), w, v1[:, :Q], a1[:, :Q], v2[:, :Q],
                                       128)


@pytest.mark.parametrize("layout", ["t", "rows"])
@pytest.mark.parametrize("warm", [False, True])
def test_select_kernel_matches_plain(dev, gen, layout, warm):
    from haconvdr_torch.ops import topk_v4 as v4

    # cold: the 2.5M-row pool [W + 8 sw, Q] (93 segments < k: no floor);
    # warm: the 1.7M-row pool [W + 4 sw, Q] at sw 128 (108 segments)
    C, Q, k = (13_282 + 4 * 128 if warm else 9766 + 8 * 256), 64, 100
    s = torch.randn(C, Q, device=dev, generator=gen)
    s[:500] = s[500:1000]  # exact duplicates: ties go to the lower row
    s[-30:] = float("-inf")
    floor = v4.warm_floor(s, k) if warm else None
    assert (floor is not None) == warm
    if layout == "t":
        got = v4.select_topk_t(s, k, floor=floor)
        ref = v4.select_plain(s.T, k, floor)
        cold = v4.select_plain(s.T, k)
    else:
        st = s.T.contiguous()
        ids = torch.randperm(C, device=dev, generator=gen).to(torch.int32)[None, :].expand(Q, -1)
        ids = ids.contiguous()
        got = v4.select_topk(st, k, floor=floor, ids=ids)
        ref = v4.select_plain(st, k, floor, ids)
        cold = v4.select_plain(st, k, None, ids)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(got[0], cold[0]) and torch.equal(got[1], cold[1])  # a floor prunes only


def _select_both(s, k, layout, floor=None, ids=None, splits=None):
    """The select kernel on [C, Q] scores in one layout (select_topk_t on
    s, or select_topk on its [Q, C] copy with ids), and select_plain."""
    from haconvdr_torch.ops import topk_v4 as v4

    if layout == "t":
        got = v4._select(s.T, k, floor, None, "select_t", splits)
        ref = v4.select_plain(s.T, k, floor)
    else:
        st = s.T.contiguous()
        if ids is None:
            ids = torch.randperm(s.shape[0], device=s.device).to(torch.int32)
        it = torch.empty_like(st, dtype=torch.int32).copy_(ids[None, :].expand(st.shape[0], -1))
        got = v4._select(st, k, floor, it, "select", splits)
        ref = v4.select_plain(st, k, floor, it)
    torch.cuda.synchronize()
    return got, ref


def _assert_bit_equal(got, ref):
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("layout", ["t", "rows"])
@pytest.mark.parametrize("Q", [1, 7, 64, 256])
@pytest.mark.parametrize("C", [9766, 11_814, 13_794, 40_000])
def test_select_kernel_shapes(dev, gen, layout, Q, C):
    """The split select at the path's panel widths (v1T, the pool, the
    1.7M-row pool) and wider, at one query, a non-multiple of 8 and more."""
    s = torch.randn(C, Q, device=dev, generator=gen) * 27.0 + 60.0
    s[C // 4: C // 4 + 300] = s[:300]  # exact duplicates: ties go to the lower id
    _assert_bit_equal(*_select_both(s, 100, layout))


@pytest.mark.parametrize("layout", ["t", "rows"])
@pytest.mark.parametrize("k", [1, 8, 100, 128])
def test_select_kernel_k(dev, gen, layout, k):
    s = torch.randn(11_814, 64, device=dev, generator=gen)
    _assert_bit_equal(*_select_both(s, k, layout))
    _assert_bit_equal(*_select_both(s, k, layout, splits=1))  # the single-launch route


@pytest.mark.parametrize("layout", ["t", "rows"])
@pytest.mark.parametrize("case", ["straddle", "all-inf", "floor-above", "few-valid"])
def test_select_kernel_edges(dev, gen, layout, case):
    C, Q, k = 11_814, 64, 100
    s = torch.randn(C, Q, device=dev, generator=gen).clamp(max=3.5)
    floor = None
    if case == "straddle":  # a tie class of 1,000 at the k-th score across every split
        s[::12] = 4.0
        s[5] = 5.0
    elif case == "all-inf":  # whole columns, and the first half of every column
        s[: C // 2] = float("-inf")
        s[:, ::3] = float("-inf")
    elif case == "floor-above":  # nothing enters
        floor = torch.full((Q,), 100.0, device=dev)
    else:  # fewer valid entries than k
        s[40:] = float("-inf")
    for splits in (None, 1, 5):
        got, ref = _select_both(s, k, layout, floor, splits=splits)
        _assert_bit_equal(got, ref)
    if case == "straddle" and layout == "t":  # the lowest rows of the class
        assert got[1][:, 0].eq(5).all()
        assert torch.equal(got[1][:, 1:], torch.arange(0, 12 * (k - 1), 12, device=dev)
                           .to(torch.int32)[None, :].expand(Q, -1))
    if case in ("floor-above", "few-valid"):
        n = 0 if case == "floor-above" else 40
        assert bool((got[1][:, n:] == -1).all()) and bool(torch.isneginf(got[0][:, n:]).all())


def test_select_ids_strides_at_one_query(dev, gen):
    """At Q = 1 the [1, C] view of a [C, 1] panel has strides (1, 1) and
    contiguous ids (C, 1): the stride of a size-1 dimension is never used."""
    from haconvdr_torch.ops import topk_v4 as v4

    s = torch.randn(11_814, 1, device=dev, generator=gen)
    ids = torch.randperm(11_814, device=dev, generator=gen).to(torch.int32)[None, :]
    got = v4.select_topk(s.T, 100, ids=ids)
    ref = v4.select_plain(s.T, 100, None, ids)
    torch.cuda.synchronize()
    _assert_bit_equal(got, ref)


@pytest.mark.parametrize("layout", ["t", "rows"])
def test_select_kernel_path_flag(dev, gen, layout):
    """The v4 search's second select: the flagged second maxima of real
    window scores, nearly all -inf, at k = budget."""
    from haconvdr_torch.ops import topk_v4 as v4

    Q, D, sw, k = 64, 64, 256, 100
    N = 9766 * sw
    p = torch.randn(N, D, device=dev, generator=gen)
    q = torch.randn(Q, D, device=dev, generator=gen)
    v1, _, v2 = v4.window_top2(q, p, N - 1000, sw)
    v_k = v4.select_topk_t(v1, k, floor=v4.warm_floor(v1, k))[0][:, k - 1]
    flagged = torch.where((v2 >= v_k[None, :]) & torch.isfinite(v2), v2, float("-inf"))
    assert 0 < int(torch.isfinite(flagged).sum()) < flagged.numel() // 100
    budget = v4.resolve_select_geometry(N, torch.float32)[1]
    _assert_bit_equal(*_select_both(flagged.contiguous(), budget, layout))
    _assert_bit_equal(*_select_both(v1, k, layout))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_topk_block_v4_matches_plain(dev, gen, dtype):
    from haconvdr_torch.ops import fused_topk as ft
    from haconvdr_torch.ops import topk_v4 as v4

    q = torch.randn(70, 768, device=dev, generator=gen)
    if dtype == torch.int8:
        p, scale = _int8_index(gen, dev, 60_000, 768)
        q = q * scale
    else:
        p = torch.randn(60_000, 768, device=dev, generator=gen).to(dtype)
    p[59_000:] = 100 if dtype == torch.int8 else p[59_000:] * 100
    before = dict(v4.COUNTS)
    s, i = v4.topk_block_v4(q, p, 59_000, 100)
    torch.cuda.synchronize()
    assert v4.COUNTS["window"] > before["window"] and v4.COUNTS["plain"] == before["plain"]
    if dtype == torch.int8:
        from haconvdr_torch.index.quantize import quantize_queries_int8

        q8, qs = quantize_queries_int8(q)
        rs, ri = ft.fused_topk_block_plain(q8, p, 59_000, 100)
        assert torch.equal(i, ri) and torch.equal(s, rs * (qs[:, None] / 127.0))
    else:
        rs, ri = ft.fused_topk_block_plain(q, p, 59_000, 100)
        assert bool(((s - rs).abs() <= 1e-4 * rs.abs()).all())
        assert torch.equal(i, ri)
    assert int(i.max()) < 59_000


def test_topk_block_v4_budget_overflow_falls_back_to_v3(dev, gen):
    from haconvdr_torch.ops import fused_topk as ft
    from haconvdr_torch.ops import topk_v4 as v4

    q = torch.randn(16, 768, device=dev, generator=gen)
    p = torch.randn(40_000, 768, device=dev, generator=gen)
    p[:2048] = p[:1].clone()  # one row planted 2048 times: every query floods its windows
    p[:2048] *= 10
    before = dict(v4.COUNTS)
    kernel_before = ft.COUNTS["kernel"]
    s, i = v4.topk_block_v4(q, p, 40_000, 100)
    torch.cuda.synchronize()
    assert v4.COUNTS["v3_fallback"] == before["v3_fallback"] + 1
    assert ft.COUNTS["kernel"] == kernel_before + 1
    rs, ri = ft.fused_topk_block_plain(q, p, 40_000, 100)
    assert torch.equal(i, ri) and bool(((s - rs).abs() <= 1e-4 * rs.abs()).all())


# --- the int8 tower kernels (ops/fused_ln.py, ops/fused_mlp.py) ------------
#
# Tolerances: y within one bf16 ulp of the twin (2**-7 |ref|, plus 1e-5 for
# values near 0; float32 out within 1e-5 (1 + |ref|)); the MLP within the
# JAX package's own bounds (tests/test_fused_mlp.py: rtol 2**-6, atol 0.07,
# flips past 2**-6 (1 + |ref|) below 2e-3).  yq and ys equal the plain
# quantization of the kernel's own y exactly; against the twin's codes they
# differ by at most 1, at under 0.1% of positions.

def _codes_close(got_q, ref_q):
    dq = (got_q.int() - ref_q.int()).abs()
    assert int(dq.max()) <= 1 and float((dq > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("rows", [1003, 1, 17, 4099])
@pytest.mark.parametrize(
    "x_dtype, res, quant, H, out_dtype",
    [
        (torch.bfloat16, True, True, 768, torch.bfloat16),   # attention residual
        (torch.float32, False, True, 768, torch.bfloat16),   # embeddings
        (torch.bfloat16, True, False, 768, torch.bfloat16),  # row 8
        (torch.bfloat16, False, False, 768, torch.bfloat16),  # row 8, no residual
        (torch.float32, True, False, 768, torch.float32),
        (torch.bfloat16, False, False, 256, torch.float32),
        (torch.float32, True, True, 96, torch.float32),
    ],
)
def test_fused_ln_kernel_matches_plain(dev, gen, x_dtype, res, quant, H, out_dtype, rows):
    """H 768 takes the fixed-width kernel (two rows a warp over a grid of
    resident blocks: 1, 17 and 4,099 rows end mid-step), 96 and 256 the
    generic one."""
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.ops import fused_ln as fl

    x = (torch.randn(rows, H, device=dev, generator=gen) * 3).to(x_dtype)
    r = torch.randn(rows, H, device=dev, generator=gen).to(x_dtype) if res else None
    scale = torch.randn(H, device=dev, generator=gen) * 0.5 + 1.0
    bias = torch.randn(H, device=dev, generator=gen) * 0.1
    key = "ln_quant" if quant else "ln"
    before = dict(fl.COUNTS)
    if quant:
        y, yq, ys = fl.fused_residual_ln_quant(x, r, scale, bias, 1e-5, out_dtype)
    else:
        y = fl.fused_residual_ln(x, r, scale, bias, 1e-5, out_dtype)
    torch.cuda.synchronize()
    assert fl.COUNTS[key] == before[key] + 1 and fl.COUNTS["plain"] == before["plain"]
    if quant:
        ry, rq, rs = fl.fused_residual_ln_quant_plain(x, r, scale, bias, 1e-5, out_dtype)
    else:
        ry = fl.fused_residual_ln_plain(x, r, scale, bias, 1e-5, out_dtype)
    assert y.dtype == out_dtype and y.shape == x.shape
    d = (y.float() - ry.float()).abs()
    if out_dtype == torch.bfloat16:
        assert bool((d <= 2.0**-7 * ry.float().abs() + 1e-5).all())
    else:
        assert bool((d <= 1e-5 * (1 + ry.abs())).all())
    if quant:
        oq, os_ = quantize_rows(y)
        assert torch.equal(yq, oq) and torch.equal(ys, os_)
        _codes_close(yq, rq)


@pytest.mark.parametrize("quant", [False, True])
def test_fused_ln_kernel_at_768_from_unaligned_rows(dev, gen, quant):
    """A bf16 view 6 bytes past a 16-byte boundary: the generic kernel
    takes it at H 768, with the fixed kernel's answer."""
    from haconvdr_torch.ops import fused_ln as fl

    rows, H = 301, 768
    buf = (torch.randn(rows * H + 3, device=dev, generator=gen) * 3).to(torch.bfloat16)
    x = buf[3:].view(rows, H)
    assert x.data_ptr() % 16 == 6
    scale = torch.randn(H, device=dev, generator=gen) * 0.5 + 1.0
    bias = torch.randn(H, device=dev, generator=gen) * 0.1
    run = fl.fused_residual_ln_quant if quant else fl.fused_residual_ln
    got = run(x, None, scale, bias, 1e-5)
    want = run(x.clone(), None, scale, bias, 1e-5)
    torch.cuda.synchronize()
    y, ry = (got[0], want[0]) if quant else (got, want)
    d = (y.float() - ry.float()).abs()
    assert bool((d <= 2.0**-7 * ry.float().abs() + 1e-5).all())
    plain = fl.fused_residual_ln_plain(x, None, scale, bias, 1e-5)
    assert bool(((y.float() - plain.float()).abs() <= 2.0**-7 * plain.float().abs() + 1e-5).all())


def _quant_weight(gen, dev, out_dim, in_dim):
    """[out, in] int8 codes and per-out-channel kernel_scale, as
    quantize_encoder_params makes them."""
    w = torch.randn(out_dim, in_dim, device=dev, generator=gen) * 0.05
    s = w.abs().amax(dim=1)
    return torch.clamp(torch.round(w / s[:, None] * 127.0), -127, 127).to(torch.int8), s / 127.0


@pytest.mark.parametrize(
    "rows, H, I",
    [(1003, 768, 3072), (37, 256, 512)]
    + [(r, 768, 3072) for r in (1, 15, 16, 17, 129, 512, 12_289)]
    + [(r, 256, 512) for r in (1, 15, 16, 17, 129, 512, 1003, 30_000)],
)
def test_fused_mlp_kernel_matches_plain(dev, gen, rows, H, I):
    """Row counts on both sides of the 128-row product tile and of the
    serving tower's 512; past 12,288 rows (PIPE_ROWS) the two-stream row
    pipeline runs, its last chunk 1 row (12,289) or ragged (30,000).  The
    256 / 512 widths end the 128-column tiles of the down-projection at
    H 256 and take the generic LayerNorm."""
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.models.encoder import mlp_block_split
    from haconvdr_torch.ops import fused_mlp as fm

    x = (torch.randn(rows, H, device=dev, generator=gen) * 2).to(torch.bfloat16)
    xq, xs = quantize_rows(x)
    w1, s1 = _quant_weight(gen, dev, I, H)
    w2, s2 = _quant_weight(gen, dev, H, I)
    b1 = torch.linspace(-0.1, 0.1, I, device=dev)
    b2 = torch.linspace(-0.1, 0.1, H, device=dev)
    lns = torch.randn(H, device=dev, generator=gen) * 0.3 + 1.0
    lnb = torch.randn(H, device=dev, generator=gen) * 0.1
    args = (x, xq, xs, w1, s1, b1, w2, s2, b2, lns, lnb)
    before = dict(fm.COUNTS)
    y, yq, ys = fm.fused_mlp_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert fm.COUNTS["kernel"] == before["kernel"] + 1 and fm.COUNTS["plain"] == before["plain"]
    ry, rq, _ = fm.fused_mlp_block_plain(*args, eps=1e-12)
    g, w = y.float(), ry.float()
    d = (g - w).abs()
    assert bool((d <= 2.0**-6 * w.abs() + 0.07).all())
    assert float((d > 2.0**-6 * (1 + w.abs())).float().mean()) < 2e-3
    oq, os_ = quantize_rows(y)
    assert torch.equal(yq, oq) and torch.equal(ys, os_)
    _codes_close(yq, rq)


@pytest.mark.parametrize("rows, H, I, tp", [(1003, 768, 3072, 2), (1003, 768, 3072, 4),
                                          (129, 256, 512, 2), (17, 256, 512, 4)])
def test_fused_mlp_split_mode_equals_the_block(dev, gen, rows, H, I, tp):
    """Row 10's split mode (the inner dimension cut over tp ranks on one
    card): each piece launches its kernels once a rank (finish once), no
    plain twin; y, yq and ys equal the un-split kernel's bit for bit, and
    the split twin the un-split twin's; kernel against twin as
    test_fused_mlp_kernel_matches_plain holds them."""
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.models.encoder import mlp_block_split
    from haconvdr_torch.ops import fused_mlp as fm

    x = (torch.randn(rows, H, device=dev, generator=gen) * 2).to(torch.bfloat16)
    xq, xs = quantize_rows(x)
    w1, s1 = _quant_weight(gen, dev, I, H)
    w2, s2 = _quant_weight(gen, dev, H, I)
    b1 = torch.linspace(-0.1, 0.1, I, device=dev)
    b2 = torch.linspace(-0.1, 0.1, H, device=dev)
    lns = torch.randn(H, device=dev, generator=gen) * 0.3 + 1.0
    lnb = torch.randn(H, device=dev, generator=gen) * 0.1
    n = I // tp
    w1s = [w1[r * n : (r + 1) * n] for r in range(tp)]
    s1s = [s1[r * n : (r + 1) * n] for r in range(tp)]
    b1s = [b1[r * n : (r + 1) * n] for r in range(tp)]
    w2s = [w2[:, r * n : (r + 1) * n].contiguous() for r in range(tp)]
    split = (x, xq, xs, w1s, s1s, b1s, w2s, s2, b2, lns, lnb)
    before = dict(fm.COUNTS)
    got = mlp_block_split(*split, eps=1e-12)
    torch.cuda.synchronize()
    delta = {k: fm.COUNTS[k] - before[k] for k in fm.COUNTS}
    assert delta == {"kernel": 0, "plain": 0, "split_up": tp, "split_down": tp,
                     "split_finish": 1, "plain_split_up": 0, "plain_split_down": 0,
                     "plain_split_finish": 0}
    whole = fm.fused_mlp_block(x, xq, xs, w1, s1, b1, w2, s2, b2, lns, lnb, eps=1e-12)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    plain = mlp_block_split(*split, eps=1e-12, plain=True)
    for g, w in zip(plain, fm.fused_mlp_block_plain(x, xq, xs, w1, s1, b1, w2, s2, b2, lns,
                                                    lnb, eps=1e-12)):
        assert torch.equal(g, w)
    d = (got[0].float() - plain[0].float()).abs()
    assert bool((d <= 2.0**-6 * plain[0].float().abs() + 0.07).all())


@pytest.mark.parametrize("M", [5, 40])
def test_int8_dense_is_exact_on_the_card(dev, gen, M):
    from haconvdr_torch.ops.fused_mlp import _int_mm

    a = torch.randint(-127, 128, (M, 768), device=dev, generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (2304, 768), device=dev, generator=gen, dtype=torch.int8)
    got = _int_mm(a, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, 2304)
    assert torch.equal(got.cpu().long(), a.cpu().long() @ w.cpu().long().T)


def test_int8_tower_wrappers_reject_unsupported(dev):
    from haconvdr_torch.ops.fused_ln import fused_residual_ln_quant
    from haconvdr_torch.ops.fused_mlp import fused_mlp_block

    v = torch.ones(48, device=dev)
    with pytest.raises(ValueError):  # H % 32
        fused_residual_ln_quant(torch.zeros(4, 48, device=dev), None, v, v)
    H, I = 96, 256  # H % 64
    x = torch.zeros(4, H, device=dev, dtype=torch.bfloat16)
    q = torch.zeros(4, H, device=dev, dtype=torch.int8)
    w1 = torch.zeros(I, H, device=dev, dtype=torch.int8)
    w2 = torch.zeros(H, I, device=dev, dtype=torch.int8)
    vi, vh = torch.ones(I, device=dev), torch.ones(H, device=dev)
    with pytest.raises(ValueError):
        fused_mlp_block(x, q, vh[:4, None], w1, vi, vi, w2, vh, vh, vh, vh)


# -- the int8 dense (ops/int8_dense.py, csrc/int8_dense.cu): bit for bit the
# plain twin (the parent's composition of quantize_rows, torch._int_mm and
# PyTorch's elementwise dequantization)

DENSE_WIDTHS = [(768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 576)]


def _dense_case(gen, dev, M, K, N, dtype):
    x = (torch.randn(M, K, device=dev, generator=gen) * 2).to(dtype)
    w, ks = _quant_weight(gen, dev, N, K)
    b = torch.linspace(-0.1, 0.1, N, device=dev)
    return x, w, ks, b


@pytest.mark.parametrize("prequant", [False, True], ids=["codes", "prequant"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, N", DENSE_WIDTHS)
@pytest.mark.parametrize("M", [1, 5, 17, 40, 131, 9_000])
def test_int8_dense_kernel_equals_the_twin(dev, gen, M, K, N, out_dtype, prequant):
    """The tile the kernel picks, from rows in the output's type (bf16 rows
    for the bf16 carry, f32 rows for the f32 one): y equal to
    ``int8_dense_plain``'s, one dense launch, and one codes launch where no
    prequant came."""
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.ops import int8_dense as idn

    x, w, ks, b = _dense_case(gen, dev, M, K, N, out_dtype)
    pq = quantize_rows(x) if prequant else None
    before = dict(idn.COUNTS)
    y = idn.int8_dense(x, w, ks, b, pq, out_dtype)
    torch.cuda.synchronize()
    assert idn.COUNTS == {**before, "dense": before["dense"] + 1,
                          "codes": before["codes"] + (0 if prequant else 1)}
    want = idn.int8_dense_plain(x, w, ks, b, pq, out_dtype)
    assert y.dtype == out_dtype and y.shape == (M, N)
    assert torch.equal(y, want)


# (M, K, N) reaching both of the kernel's tiles, 128 and 64 rows of 192
# columns: 128 where ceil(M / 128) * ceil(N / 192) tiles fill the card's
# 132 SMs once, else 64
DENSE_TILE_CASES = [
    (40, 768, 640),  # 64 rows; 640 masks the last tile's second and third 64 columns
    (9_000, 768, 640),  # 128 rows, the same mask
    (131, 768, 576),  # 64 rows, a tp rank's QKV
    (40, 768, 1152),  # 64 rows
    (9_000, 3072, 768),  # 128 rows, the f32-carry tower's down dense
    (9_000, 768, 64),  # 64 rows, N under one tile
    (20_000, 768, 64),  # 128 rows, N under one tile
]


@pytest.mark.parametrize("M, K, N", DENSE_TILE_CASES)
def test_int8_dense_every_tile_equals_the_twin(dev, gen, M, K, N):
    """Both tiles, reached through M (DENSE_TILE_CASES), on masked column
    tiles (N not a multiple of 192, N under one tile), ragged rows and
    K 3,072: bf16 and f32 y equal to the twin's."""
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.ops import int8_dense as idn

    x, w, ks, b = _dense_case(gen, dev, M, K, N, torch.bfloat16)
    pq = quantize_rows(x)
    for dt in (torch.bfloat16, torch.float32):
        y = idn.int8_dense(x, w, ks, b, pq, dt)
        assert torch.equal(y, idn.int8_dense_plain(x, w, ks, b, pq, dt)), dt


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows, K", [(1, 768), (37, 64), (4_099, 768), (1_003, 3072)])
def test_row_codes_kernel_equals_quantize_rows(dev, gen, dtype, rows, K):
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.ops import int8_dense as idn

    x = (torch.randn(rows, K, device=dev, generator=gen) * 3).to(dtype)
    x[0, : K // 2] = 0  # a half-empty row
    if rows > 1:
        x[1] = 0  # an empty row: the scale's floor
    q, s = idn.row_codes(x)
    rq, rs = quantize_rows(x)
    assert q.dtype == torch.int8 and s.shape == (rows, 1)
    assert torch.equal(q, rq) and torch.equal(s, rs)


def test_packed_int8_tower_through_the_dense_kernel_equals_the_parents_route(dev, monkeypatch):
    """The packed int8 bf16 tower (ANCE-base widths, quantize_encoder_params)
    with Int8Linear on the kernels against the same tower with Int8Linear on
    its plain twin (the parent's route; every other kernel the same): the
    embeddings bit for bit, one dense launch a CUDA Int8Linear call (QKV and
    the attention output, 24), codes for the output dense alone (12), no
    twin."""
    import numpy as np

    from haconvdr_torch.models.encoder import Int8Linear
    from haconvdr_torch.ops import int8_dense as idn

    enc = _base_tower(True, dev)
    rng = np.random.RandomState(12)
    B, L = 32, 384
    lens = rng.randint(32, L + 1, B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(3, 50265, (B, L)) * mask).astype(np.int32)
    x, m = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    calls = []
    forward = Int8Linear.forward

    def counted(self, *args, **kw):
        calls.append(1)
        return forward(self, *args, **kw)

    monkeypatch.setattr(Int8Linear, "forward", counted)
    for k in idn.COUNTS:
        idn.COUNTS[k] = 0
    with torch.inference_mode():
        got = enc(x, m, host_mask=mask)
        torch.cuda.synchronize()
        counts, n_calls = dict(idn.COUNTS), len(calls)
        monkeypatch.setattr(idn, "int8_dense", idn.int8_dense_plain)
        want = enc(x, m, host_mask=mask)
    assert counts == {"dense": n_calls, "codes": 12, "plain": 0} and n_calls == 24
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "unfused"])
def test_int8_tp2_split_tower_equals_the_unsplit_one_on_the_card(dev, use_fused):
    """Two tp ranks on one card (ANCE widths, 2 layers, bf16 carry): the
    ranks' column denses (QKV, 1,152 columns; unfused also the FFN up, 1,536)
    go through the dense kernel, the row denses through the int32 partials;
    the embeddings equal the un-split tower's bit for bit."""
    import numpy as np

    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params
    from haconvdr_torch.ops import int8_dense as idn
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.parallel.sharded_encode import dp_encode_fn, shard_params

    cfg = ModelConfig(dtype="bfloat16", num_hidden_layers=2, use_fused_ln=use_fused,
                      use_fused_mlp=use_fused)
    params = quantize_encoder_params(init_params_numpy(cfg, seed=9))
    rng = np.random.RandomState(13)
    B, L = 16, 128
    lens = rng.randint(8, L + 1, B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(3, 50265, (B, L)) * mask).astype(np.int32)
    with torch.inference_mode():
        ref = AnceEncoder.from_jax_params(params, cfg, dev)(
            torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)).cpu()
        mesh = make_mesh(dp=1, tp=2, devices=[dev, dev])
        for k in idn.COUNTS:
            idn.COUNTS[k] = 0
        out = dp_encode_fn(mesh, shard_params(mesh, params, tp=True, cfg=cfg))(
            torch.from_numpy(ids), torch.from_numpy(mask)).cpu()
    per_rank = 1 if use_fused else 2  # QKV; unfused also the FFN up
    assert idn.COUNTS["dense"] == 2 * per_rank * cfg.num_hidden_layers
    assert idn.COUNTS["plain"] == 0
    assert torch.equal(out, ref)


def test_int8_dense_wrapper_rejects_unsupported(dev):
    from haconvdr_torch.ops import int8_dense as idn

    x = torch.zeros(8, 768, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(768, 768, device=dev, dtype=torch.int8)
    v = torch.ones(768, device=dev)
    with pytest.raises(ValueError):  # K % 64
        idn.int8_dense(torch.zeros(8, 96, device=dev),
                       torch.zeros(768, 96, device=dev, dtype=torch.int8), v, v)
    with pytest.raises(ValueError):  # a float weight
        idn.int8_dense(x, w.float(), v, v)
    off_w = torch.zeros(768 * 768 + 1, device=dev, dtype=torch.int8)[1:].view(768, 768)
    with pytest.raises(ValueError):  # a weight off its 16-byte boundary
        idn.int8_dense(x, off_w, v, v)
    off_x = torch.zeros(8 * 768 + 1, device=dev, dtype=torch.bfloat16)[1:].view(8, 768)
    with pytest.raises(ValueError):  # rows off their 16-byte boundary
        idn.int8_dense(off_x, w, v, v)
    with pytest.raises(ValueError):  # N % 64
        idn.int8_dense(x, torch.zeros(100, 768, device=dev, dtype=torch.int8), v[:100], v[:100])


def _bf16_ulp_of_max(t):
    import math

    top = float(t.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _assert_dqkv_parts(got, want):
    """dQ, dK and dV of a bf16 dqkv [B, L, 3 * 768] each within one bf16 ulp
    of its own largest magnitude (exact where that is 0)."""
    for i in range(3):
        g, w = got[..., i * 768 : (i + 1) * 768], want[..., i * 768 : (i + 1) * 768]
        err = float((g.float() - w.float()).abs().max())
        assert err <= _bf16_ulp_of_max(w), ("QKV"[i], err, _bf16_ulp_of_max(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [77, 512])
def test_flash_attention_kernels_match_plain(dev, gen, dtype, rate, L):
    """Rows 11-12: forward and dqkv against the plain twins on the same
    seed words: float32 within 1e-5, bfloat16 within one bf16 ulp of the
    largest magnitude (dQ, dK and dV each of its own)."""
    from haconvdr_torch.ops import flash_attention as fa

    qkv = (torch.randn(2, L, 3 * 768, device=dev, generator=gen) * 0.5).to(dtype)
    go = torch.randn(2, L, 768, device=dev, generator=gen).to(dtype)
    mask = torch.ones(2, L, dtype=torch.int32, device=dev)
    mask[1, L // 3 :] = 0
    seed = (2**31 - 5, -(2**31) + 3)
    before = dict(fa.COUNTS)
    x = qkv.clone().requires_grad_(True)
    out = fa.flash_attention(x, mask, 12, seed=seed, drop_rate=rate)
    out.backward(go)
    torch.cuda.synchronize()
    assert fa.COUNTS["fwd"] == before["fwd"] + 1 and fa.COUNTS["bwd"] == before["bwd"] + 1
    assert fa.COUNTS["plain_fwd"] == before["plain_fwd"]
    ref = fa.flash_attention_fwd_plain(qkv, mask, 12, seed, rate)
    rdq = fa.flash_attention_bwd_plain(qkv, mask, go, 12, seed, rate)
    for got, want in ((out.detach(), ref), (x.grad, rdq)):
        assert got.dtype == dtype and got.shape == want.shape
        tol = 1e-5 if dtype == torch.float32 else _bf16_ulp_of_max(want)
        assert float((got.float() - want.float()).abs().max()) <= tol
    if dtype == torch.bfloat16:
        _assert_dqkv_parts(x.grad, rdq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_row_offset_draws_the_whole_batchs_masks(dev, gen, dtype):
    """Rows 11-12 launched on rows a:b with row_offset=a: forward output,
    row stats and dqkv equal rows a:b of the whole-batch launch bit for
    bit, and the plain twins with the same offset within
    test_flash_attention_kernels_match_plain's bounds."""
    from haconvdr_torch.ops import flash_attention as fa

    B, L, rate, seed = 6, 200, 0.1, (77, -13)
    qkv = (torch.randn(B, L, 3 * 768, device=dev, generator=gen) * 0.5).to(dtype)
    go = torch.randn(B, L, 768, device=dev, generator=gen).to(dtype)
    mask = torch.ones(B, L, dtype=torch.int32, device=dev)
    mask[1, L // 3 :] = 0
    mask[4, 40:] = 0
    out, stats = fa._fwd_kernel(qkv, mask, 12, seed, rate)
    dq = fa._bwd_kernel(qkv, mask, stats, go, 12, seed, rate)
    for a, b in ((2, 5), (5, 6)):
        o, st = fa._fwd_kernel(qkv[a:b].contiguous(), mask[a:b].contiguous(), 12, seed, rate, a)
        d = fa._bwd_kernel(qkv[a:b].contiguous(), mask[a:b].contiguous(), st,
                           go[a:b].contiguous(), 12, seed, rate, a)
        torch.cuda.synchronize()
        assert torch.equal(o, out[a:b]) and torch.equal(st, stats[a:b])
        assert torch.equal(d, dq[a:b])
        ref = fa.flash_attention_fwd_plain(qkv[a:b], mask[a:b], 12, seed, rate, a)
        rdq = fa.flash_attention_bwd_plain(qkv[a:b], mask[a:b], go[a:b], 12, seed, rate, a)
        for got, want in ((o, ref), (d, rdq)):
            tol = 1e-5 if dtype == torch.float32 else _bf16_ulp_of_max(want)
            assert float((got.float() - want.float()).abs().max()) <= tol
    o0, _ = fa._fwd_kernel(qkv[2:5].contiguous(), mask[2:5].contiguous(), 12, seed, rate)
    assert not torch.equal(o0, out[2:5])  # offset 0 draws rows 0-2's masks


# --- the bf16 tensor-core forward (csrc/attention_tc.cuh) of rows 1 and 11 --

TC_LENGTHS = [1, 16, 77, 130, 384, 512]


def _tc_mask(L, dev):
    """[6, L]: a full row, a prefix, holes, valid keys only at both ends
    (all-padded key tiles between them), one valid key, no valid key."""
    m = torch.zeros(6, L, dtype=torch.int32)
    m[0] = 1
    m[1, : max(1, 2 * L // 3)] = 1
    m[2, ::7] = 1
    m[3, :5] = 1
    m[3, max(0, L - 3) :] = 1
    m[4, L // 2] = 1
    return m.to(dev)


def _ragged_mask(gen, dev, B, L):
    lengths = torch.randint(L // 8, L + 1, (B,), device=dev, generator=gen)
    return (torch.arange(L, device=dev)[None, :] < lengths[:, None]).to(torch.int32)


def _check_tc_inference(qkv, mask):
    from haconvdr_torch.ops import flash_attention as fl
    from haconvdr_torch.ops import fused_attention as fa

    before = fa.COUNTS["kernel"]
    out = fa.fused_attention_qkv(qkv, mask, 12)
    torch.cuda.synchronize()
    assert fa.COUNTS["kernel"] == before + 1
    ref = fa.fused_attention_qkv_plain(qkv, mask, 12)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= 2.0**-6 + 2.0**-8 * ref.float().abs()).all()), float(diff.max())
    # the flash forward without dropout runs the same kernel body
    assert torch.equal(out, fl._fwd_kernel(qkv, mask.contiguous(), 12, None, 0.0)[0])


def _check_tc_flash(qkv, mask, go, rate):
    from haconvdr_torch.ops import flash_attention as fa

    seed = (-(2**31) + 11, 2**31 - 7)
    before = dict(fa.COUNTS)
    x = qkv.clone().requires_grad_(True)
    out = fa.flash_attention(x, mask, 12, seed=seed, drop_rate=rate)
    out.backward(go)
    torch.cuda.synchronize()
    assert fa.COUNTS["fwd"] == before["fwd"] + 1 and fa.COUNTS["bwd"] == before["bwd"] + 1
    ref = fa.flash_attention_fwd_plain(qkv, mask, 12, seed, rate)
    rdq = fa.flash_attention_bwd_plain(qkv, mask, go, 12, seed, rate)
    assert float((out.detach().float() - ref.float()).abs().max()) <= _bf16_ulp_of_max(ref)
    _assert_dqkv_parts(x.grad, rdq)


@pytest.mark.parametrize("L", TC_LENGTHS)
def test_tc_inference_attention_edges(dev, gen, L):
    """Row 1, bf16: within 2**-6 + 2**-8 |ref| of the twin on holes,
    all-padded key tiles, one valid key and a row with none."""
    qkv = torch.randn(6, L, 3 * 768, device=dev, generator=gen).to(torch.bfloat16)
    _check_tc_inference(qkv, _tc_mask(L, dev))


@pytest.mark.parametrize("L", TC_LENGTHS)
def test_tc_flash_attention_edges(dev, gen, L):
    """Rows 11-12, bf16, dropout 0.1: the forward within one bf16 ulp of the
    twin's largest magnitude, dQ, dK and dV each within one of its own, on
    the same masks."""
    qkv = (torch.randn(6, L, 3 * 768, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
    go = torch.randn(6, L, 768, device=dev, generator=gen).to(torch.bfloat16)
    _check_tc_flash(qkv, _tc_mask(L, dev), go, 0.1)


@pytest.mark.parametrize("row", ["inference", "flash"])
def test_tc_forward_at_the_frozen_tower_shape(dev, gen, row):
    """B 64, L 384 (the frozen passage towers' shape), ragged lengths."""
    B, L = 64, 384
    qkv = (torch.randn(B, L, 3 * 768, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
    mask = _ragged_mask(gen, dev, B, L)
    if row == "inference":
        _check_tc_inference(qkv, mask)
    else:
        go = torch.randn(B, L, 768, device=dev, generator=gen).to(torch.bfloat16)
        _check_tc_flash(qkv, mask, go, 0.1)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("qk_scale", [1.0, 8.0, 24.0])
def test_tc_backward_rebuilds_the_forwards_probabilities_bit_for_bit(dev, gen, rate, qk_scale):
    """With V the identity of each head (L 64 = d) the forward's output row
    q0 is bf16(Pt[q0, :]) exactly, and with a grad_out whose only nonzero
    row is q0 (all ones) every column of dV is the backward's bf16(Pt[q0,
    :]): the two must be equal bit for bit.  qk_scale spreads the scores
    (row std ~0.25, 2 and 6): the forward's division (div_rn, or IEEE where
    a probability falls below 2^-64) against the backward's IEEE one."""
    from haconvdr_torch.ops import flash_attention as fa

    B, L, nh, q0 = 2, 64, 12, 5
    qkv = torch.randn(B, L, 3 * 768, device=dev, generator=gen) * 0.5
    qkv[:, :, : 2 * 768] *= qk_scale
    qkv = qkv.to(torch.bfloat16)
    qkv[:, :, 2 * 768 :] = torch.eye(L, device=dev, dtype=torch.bfloat16).repeat(1, nh)
    mask = torch.ones(B, L, dtype=torch.int32, device=dev)
    mask[1, 40:] = 0
    go = torch.zeros(B, L, 768, device=dev, dtype=torch.bfloat16)
    go[:, q0] = 1
    x = qkv.clone().requires_grad_(True)
    out = fa.flash_attention(x, mask, nh, seed=(97, -5), drop_rate=rate)
    out.backward(go)
    torch.cuda.synchronize()
    fwd = out.detach()[:, q0].view(B, nh, L)  # [b, h, key]
    dv = x.grad[:, :, 2 * 768 :].view(B, L, nh, 64)  # [b, key, h, d]
    assert torch.equal(dv, dv[..., :1].expand_as(dv))
    assert torch.equal(fwd, dv[..., 0].permute(0, 2, 1))
    assert bool((fwd[0] > 0).any()) and bool((fwd[1, :, 40:] == 0).all())
    if rate > 0:
        assert bool((fwd[0] == 0).any())  # dropped keys


# --- the bf16 tensor-core backward (csrc/attention_tc_bwd.cuh) of row 12 ----

def _check_tc_backward(qkv, mask, go, rate):
    """The backward kernels alone (row stats from the forward kernel) against
    flash_attention_bwd_plain: dQ, dK and dV each within one bf16 ulp of
    its own largest magnitude; returns dqkv."""
    from haconvdr_torch.ops import flash_attention as fa

    seed = (1234567, -7654321)
    m = mask.contiguous()
    _, stats = fa._fwd_kernel(qkv, m, 12, seed, rate)
    before = dict(fa.COUNTS)
    dqkv = fa._bwd_kernel(qkv, m, stats, go, 12, seed, rate)
    torch.cuda.synchronize()
    assert fa.COUNTS["bwd"] == before["bwd"] + 1 and fa.COUNTS["plain_bwd"] == before["plain_bwd"]
    want = fa.flash_attention_bwd_plain(qkv, mask, go, 12, seed, rate)
    assert dqkv.dtype == torch.bfloat16 and dqkv.shape == want.shape
    _assert_dqkv_parts(dqkv, want)
    return dqkv


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", TC_LENGTHS)
def test_tc_backward_matches_plain(dev, gen, L, rate):
    """Row 12, bf16: dqkv on a full row, a prefix, holes, valid keys only at
    both ends (all-masked key tiles between them), one valid key and no
    valid key (nothing skipped there)."""
    qkv = (torch.randn(6, L, 3 * 768, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
    go = torch.randn(6, L, 768, device=dev, generator=gen).to(torch.bfloat16)
    _check_tc_backward(qkv, _tc_mask(L, dev), go, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tc_backward_at_the_training_shape(dev, gen, rate):
    """B 64, L 512 with query lengths 64-512 (chip_smoke.py phase 9's shape)."""
    B, L = 64, 512
    qkv = (torch.randn(B, L, 3 * 768, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
    go = torch.randn(B, L, 768, device=dev, generator=gen).to(torch.bfloat16)
    _check_tc_backward(qkv, _ragged_mask(gen, dev, B, L), go, rate)


def test_tc_backward_is_deterministic(dev, gen):
    """No atomics: two runs on the same inputs give equal dqkv bit for bit."""
    from haconvdr_torch.ops import flash_attention as fa

    B, L = 16, 512
    qkv = (torch.randn(B, L, 3 * 768, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
    go = torch.randn(B, L, 768, device=dev, generator=gen).to(torch.bfloat16)
    mask = _ragged_mask(gen, dev, B, L)
    seed = (5, 6)
    _, stats = fa._fwd_kernel(qkv, mask, 12, seed, 0.1)
    a = fa._bwd_kernel(qkv, mask, stats, go, 12, seed, 0.1)
    b = fa._bwd_kernel(qkv, mask, stats, go, 12, seed, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# --- the f32 route of row 1 on 3xTF32 (csrc/attention_tf32.cuh) -----------

@pytest.mark.parametrize("spread", [1.0, 3.0])
@pytest.mark.parametrize("L", [1, 77, 130, 512])
def test_f32_inference_attention_edges(dev, gen, L, spread):
    """Row 1, f32: within 1e-4 of the twin on holes, all-masked key tiles,
    one valid key and a fully masked row; spread 3 scales Q and K (peaked
    rows, larger scores)."""
    from haconvdr_torch.ops import fused_attention as fa

    qkv = torch.randn(6, L, 3 * 768, device=dev, generator=gen)
    qkv[:, :, : 2 * 768] *= spread
    mask = _tc_mask(L, dev)
    before = fa.COUNTS["kernel"]
    out = fa.fused_attention_qkv(qkv, mask, 12)
    torch.cuda.synchronize()
    assert fa.COUNTS["kernel"] == before + 1
    ref = fa.fused_attention_qkv_plain(qkv, mask, 12)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 1e-4


def test_f32_inference_attention_is_the_f32_flash_forward_body(dev, gen):
    """Rows 1 and 11 share one 3xTF32 forward (attention_tf32.cuh): row 1's
    output equals row 11's f32 forward at dropout 0 bit for bit, on the edge
    masks and at the frozen towers' B 64, L 384."""
    from haconvdr_torch.ops import flash_attention as fl
    from haconvdr_torch.ops import fused_attention as fa

    for L, mask in ((130, _tc_mask(130, dev)), (384, _ragged_mask(gen, dev, 64, 384))):
        qkv = torch.randn(mask.shape[0], L, 3 * 768, device=dev, generator=gen)
        out = fa.fused_attention_qkv(qkv, mask, 12)
        torch.cuda.synchronize()
        assert torch.equal(out, fl._fwd_kernel(qkv, mask.contiguous(), 12, None, 0.0)[0])


# --- the f32 route of rows 11-12 on 3xTF32 (attention_tf32.cuh, _bwd.cuh) ---

def _check_f32_flash(qkv, mask, go, rate, f32_twin):
    """Rows 11-12, f32, through flash_attention, one launch each.  The
    forward, dQ, dK and dV are held element by element to the twins run in
    float64 on the same values, within 1e-5 times the larger of 1 and that
    element's magnitude, and, with ``f32_twin``, to the twins in float32
    within 1e-5.

    Why float64 and why scaled: a key with few valid rows sums up to L rows
    of dO into its dV (one valid key at L 512: |dV| ~85, where 1e-5 is about
    one float32 ulp), and no float32 sum holds that to 1e-5 absolute.  The
    scale is the element's own, so every element below 1 in magnitude, the
    ordinary rows beside such a key among them, is held to 1e-5 absolute.  On
    the edge masks at L 512 the float32 twins' dV is up to 7.9e-5 off
    float64 and the kernels' up to 1.1e-5, and with Q and K scaled by 3 the
    3xTF32 scores put the kernels' forward 9.6e-6 off
    (probes/probe_torch_f32_attention.py, NVIDIA H100 80GB HBM3, 700 W).
    A batch row without a valid key takes the float32 twins as reference:
    float32 rounds its scores s - 1e9 to one value (a uniform softmax, as
    the reference computes it), float64 does not."""
    from haconvdr_torch.ops import flash_attention as fa

    seed = (-(2**31) + 11, 2**31 - 7)
    before = dict(fa.COUNTS)
    x = qkv.clone().requires_grad_(True)
    out = fa.flash_attention(x, mask, 12, seed=seed, drop_rate=rate)
    out.backward(go)
    torch.cuda.synchronize()
    assert fa.COUNTS["fwd"] == before["fwd"] + 1 and fa.COUNTS["bwd"] == before["bwd"] + 1
    assert fa.COUNTS["plain_fwd"] == before["plain_fwd"]
    assert out.dtype == x.grad.dtype == torch.float32

    def twins(dt):
        return (fa.flash_attention_fwd_plain(qkv.to(dt), mask, 12, seed, rate).double(),
                fa.flash_attention_bwd_plain(qkv.to(dt), mask, go.to(dt), 12, seed, rate)
                .double())

    def parts(o, dqkv):  # out, dQ, dK, dV
        return [o] + [dqkv[..., i * 768:(i + 1) * 768] for i in range(3)]

    r32, r64 = twins(torch.float32), twins(torch.float64)
    valid = mask.bool().any(1)[:, None, None]
    ref = [torch.where(valid, a, b) for a, b in zip(r64, r32)]
    got = parts(out.detach().double(), x.grad.double())
    for name, g, w in zip(("out", "dQ", "dK", "dV"), got, parts(*ref)):
        diff = (g - w).abs()
        worst = float((diff / w.abs().clamp(min=1.0)).max())
        assert worst <= 1e-5, (name, worst, float(diff.max()))
    if f32_twin:
        for name, g, w in zip(("out", "dQ", "dK", "dV"), got, parts(*r32)):
            assert float((g - w).abs().max()) <= 1e-5, name


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("spread", [1.0, 3.0])
@pytest.mark.parametrize("L", TC_LENGTHS)
def test_f32_flash_attention_edges(dev, gen, L, spread, rate):
    """Rows 11-12, f32: a full row, a prefix, holes, valid keys only at both
    ends (all-masked key tiles between them), one valid key and none;
    spread 3 scales Q and K (peaked rows).  Held to the float64 twins (see
    _check_f32_flash)."""
    qkv = torch.randn(6, L, 3 * 768, device=dev, generator=gen) * 0.5
    qkv[:, :, : 2 * 768] *= spread
    go = torch.randn(6, L, 768, device=dev, generator=gen)
    _check_f32_flash(qkv, _tc_mask(L, dev), go, rate, f32_twin=False)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_flash_attention_at_the_training_shape(dev, gen, rate):
    """B 64, L 512 with query lengths 64-512 (chip_smoke.py phase 11), held
    to the float32 twins within 1e-5 as well."""
    B, L = 64, 512
    qkv = torch.randn(B, L, 3 * 768, device=dev, generator=gen) * 0.5
    go = torch.randn(B, L, 768, device=dev, generator=gen)
    _check_f32_flash(qkv, _ragged_mask(gen, dev, B, L), go, rate, f32_twin=True)


def test_f32_backward_is_deterministic(dev, gen):
    """No atomics: two runs of the f32 backward give equal dqkv bit for bit."""
    from haconvdr_torch.ops import flash_attention as fa

    B, L = 16, 512
    qkv = torch.randn(B, L, 3 * 768, device=dev, generator=gen) * 0.5
    go = torch.randn(B, L, 768, device=dev, generator=gen)
    mask = _ragged_mask(gen, dev, B, L)
    _, stats = fa._fwd_kernel(qkv, mask, 12, (5, 6), 0.1)
    a = fa._bwd_kernel(qkv, mask, stats, go, 12, (5, 6), 0.1)
    b = fa._bwd_kernel(qkv, mask, stats, go, 12, (5, 6), 0.1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_f32_flash_kernels_refuse_unaligned_qkv(dev):
    """cp.async moves 16-byte rows: an f32 qkv view that starts 4 bytes into
    its storage is refused with an error, never run through a twin."""
    from haconvdr_torch.ops import flash_attention as fa

    buf = torch.zeros(1 * 8 * 3 * 768 + 1, device=dev)
    qkv = buf[1:].view(1, 8, 3 * 768)
    before = dict(fa.COUNTS)
    with pytest.raises(RuntimeError, match="hc_flash_fwd"):
        fa.flash_attention(qkv, torch.ones(1, 8, dtype=torch.int32, device=dev), 12)
    assert fa.COUNTS == before


def test_flash_attention_rejects_unsupported(dev):
    from haconvdr_torch.ops.flash_attention import flash_attention

    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros(1, 8, 3 * 96, device=dev), torch.ones(1, 8, device=dev), 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(torch.zeros(1, 3 * 768, 8, device=dev).transpose(1, 2),
                        torch.ones(1, 8, device=dev), 12)


def test_bf16_dense_gradient_on_the_card(dev, gen):
    """The bf16 dense (one bf16 GEMM with a float32 result) is
    differentiable: its gradients equal float32 products of the
    bf16-rounded operands, rounded to bf16."""
    from torch import nn

    from haconvdr_torch.models.encoder import _dense

    lin = nn.Linear(96, 40).to(dev)
    x = torch.randn(3, 7, 96, device=dev, generator=gen).requires_grad_(True)
    y = _dense(x, lin, torch.bfloat16)
    assert y.dtype == torch.float32
    g = torch.randn(y.shape, device=dev, generator=gen)
    y.backward(g)
    gb = g.to(torch.bfloat16).float().reshape(-1, 40)
    wb, xb = lin.weight.to(torch.bfloat16).float(), x.detach().to(torch.bfloat16).float()
    want_x = (gb @ wb).to(torch.bfloat16).float().reshape(x.shape)
    want_w = (gb.T @ xb.reshape(-1, 96)).to(torch.bfloat16).float()
    torch.testing.assert_close(x.grad, want_x, rtol=2**-7, atol=1e-6)
    torch.testing.assert_close(lin.weight.grad, want_w, rtol=2**-7, atol=1e-6)
    torch.testing.assert_close(lin.bias.grad, g.reshape(-1, 40).sum(0), rtol=1e-5, atol=1e-5)


def test_two_train_steps_on_the_card(dev):
    """make_train_step on the card with bf16 towers and int8 frozen towers:
    two micro steps with accumulation 2 apply one update, launch the flash
    kernels once a layer per step and the frozen int8 kernels, no plain
    twin, and leave the frozen tower unchanged."""
    import numpy as np

    from haconvdr_torch.config import ModelConfig, TrainConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.ops import flash_attention as fa
    from haconvdr_torch.ops import fused_mlp
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.train.trainer import (
        build_frozen_encoder,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    cfg = ModelConfig(num_hidden_layers=2, dtype="bfloat16", remat="mlp", vocab_size=1000)
    tcfg = TrainConfig(accumulation_steps=2, learning_rate=1e-4, is_pseudo_prepos=False,
                       is_prepos_neg=False, frozen_dtype="int8")
    opt = make_optimizer(tcfg, total_steps=10)
    step = make_train_step(make_mesh(devices=[dev]), cfg, tcfg, opt)
    state = init_train_state(AnceEncoder.from_jax_params(init_params_numpy(cfg, 0), cfg, dev), opt)
    frozen = build_frozen_encoder(init_params_numpy(cfg, 1), cfg, tcfg, dev)
    before = {k: v.clone() for k, v in frozen.state_dict().items()}
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(3, 1000, (4, n)).astype(np.int32)
             for k, n in (("conv_qp", 64), ("pos_docs", 48), ("neg_docs", 48))}
    batch.update({f"{k}_mask": np.ones((4, n), np.int32)
                  for k, n in (("conv_qp", 64), ("pos_docs", 48), ("neg_docs", 48))})
    batch["valid"] = np.ones(4, np.int32)
    c0, m0 = dict(fa.COUNTS), fused_mlp.COUNTS["kernel"]
    losses = [float(step(state, frozen, batch)[1]) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(np.isfinite(losses)) and state.global_step == 1 and state.micro_step == 0
    assert fa.COUNTS["fwd"] - c0["fwd"] == 4 and fa.COUNTS["bwd"] - c0["bwd"] == 4
    assert fa.COUNTS["plain_fwd"] == c0["plain_fwd"] and fa.COUNTS["plain_bwd"] == c0["plain_bwd"]
    assert fused_mlp.COUNTS["kernel"] - m0 == 2 * 2 * 2  # 2 frozen forwards x 2 layers x 2 steps
    for k, v in frozen.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_retriever_load_and_http_server_answer_as_on_the_cpu(dev, tmp_path, monkeypatch):
    """Retriever.load (a two-layer checkpoint with 64-wide heads, the width
    the attention kernel takes; a 5,000 x 64 float32 store) behind
    RetrievalServer(max_batch=1) on the card and on the CPU, top 20.  On
    each device the HTTP answers equal Retriever.retrieve bit for bit;
    across devices the scores agree within 1e-4 relative plus delta, and
    the ids wherever neighbouring scores (the 21st included) are further
    apart than 1e-5 relative plus 2 delta, where delta = ||q_cuda - q_cpu||
    x the largest row norm bounds how far the two towers' embeddings can
    move a score.  The tokenizer comes from the HashTokenizer stand-in for
    ``transformers``."""
    import json
    import sys
    import urllib.request

    import numpy as np

    from haconvdr_torch.config import DataConfig, ModelConfig, SearchConfig
    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.hf_import import save_hf_checkpoint
    from haconvdr_torch.serve import Retriever
    from haconvdr_torch.serve_http import RetrievalServer
    from haconvdr_torch.utils.testing import hash_tokenizer_transformers

    cfg = ModelConfig.tiny(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                           vocab_size=512, embedding_dim=64, max_position_embeddings=130)
    save_hf_checkpoint(init_params_numpy(cfg, seed=2), cfg, str(tmp_path / "ckpt"))
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5000, 64)).astype(np.float32)
    store = EmbeddingBlockStore(str(tmp_path / "emb"))
    store.write_block(0, rows, np.arange(5000, dtype=np.int64))
    max_norm = float(np.linalg.norm(rows, axis=1).max())
    monkeypatch.setitem(sys.modules, "transformers", hash_tokenizer_transformers(512))
    questions = [f"w{i} w{i + 1} about w{3 * i}" for i in range(12)]
    answers, embs = {}, {}
    for name in ("cuda", "cpu"):
        r = Retriever.load(str(tmp_path / "ckpt"), str(tmp_path / "emb"),
                           data_cfg=DataConfig(is_train=False, use_PRL=False, max_concat_length=64),
                           search_cfg=SearchConfig(top_k=21), device=name)
        assert r.index.passages.device.type == name
        with RetrievalServer(r, port=0, max_batch=1).start() as srv:
            req = urllib.request.Request(
                f"http://{srv.host}:{srv.port}/retrieve_batch", method="POST",
                data=json.dumps({"queries": [{"question": q, "k": 20} for q in questions]}).encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                answers[name] = [[(h["pid"], h["score"]) for h in x["hits"]]
                                 for x in json.loads(resp.read())["results"]]
        assert answers[name] == [r.retrieve(q, k=20) for q in questions]
        embs[name] = r.embed([r.build_query(q) for q in questions])
        if name == "cpu":  # with the 21st, the gap past the last rank is known
            answers["cpu"] = [r.retrieve(q, k=21) for q in questions]
    for n, (got, want) in enumerate(zip(answers["cuda"], answers["cpu"])):
        delta = float(np.linalg.norm(embs["cuda"][n] - embs["cpu"][n])) * max_norm
        s, rs = np.array([x for _, x in got]), np.array([x for _, x in want])
        assert len(got) == 20 and len(want) == 21
        assert np.all(np.abs(s - rs[:20]) <= 1e-4 * np.abs(rs[:20]) + delta)
        gap = np.abs(np.diff(rs)) > 1e-5 * np.abs(rs[1:]) + 2 * delta  # 20 gaps
        sep = np.concatenate([[True], gap[:-1]]) & gap
        ids, rids = np.array([p for p, _ in got]), np.array([p for p, _ in want[:20]])
        assert np.array_equal(ids[sep], rids[sep])
        assert sep.sum() >= 10  # most ranks are separated


def _ivf_mixture(n, d, modes=64, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((modes, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, modes, n)] + 0.2 * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8_global", "int8_residual"])
def test_ivf_search_on_the_card_answers_as_on_the_cpu(dev, dtype):
    """ivf_search of one index on the card and on the CPU: scores within 1e-4
    relative, ids identical wherever neighbouring scores differ by more than
    1e-5 |s| (two float32 sums in another order), at partial and full probe
    and through the probe-group merge."""
    import numpy as np

    from haconvdr_torch.index import ivf

    x = _ivf_mixture(20_000, 96)
    q = _ivf_mixture(64, 96, seed=1)
    base = "bfloat16" if dtype == "bfloat16" else "float32"
    index = ivf.build_ivf(x, nlist=64, nprobe=8, dtype=base, device=dev)
    if dtype.startswith("int8"):
        index = ivf.quantize_ivf(index, by_residual=dtype == "int8_residual")
    cpu = ivf.IVFIndex(*[t.cpu() if isinstance(t, torch.Tensor) else t for t in index])
    for nprobe in (8, 64):
        s, i = ivf.ivf_search(index, q, k=50, nprobe=nprobe)
        rs, ri = ivf.ivf_search(cpu, q, k=50, nprobe=nprobe)
        assert np.all(np.abs(s - rs) <= 1e-4 * np.abs(rs))
        gap = np.abs(np.diff(rs, axis=1)) > 1e-5 * np.abs(rs[:, 1:])
        sep = np.concatenate([np.ones((64, 1), bool), gap], 1) & np.concatenate(
            [gap, np.ones((64, 1), bool)], 1)
        assert sep.mean() > 0.9 and np.array_equal(i[sep], ri[sep])
    old = ivf.PANEL_BYTES
    try:
        ivf.PANEL_BYTES = 3 * index.buckets.shape[1] * 96 * 4  # one query, three probes
        s2, i2 = ivf.ivf_search(index, q, k=50, nprobe=64)
    finally:
        ivf.PANEL_BYTES = old
    assert np.array_equal(i2[sep], i[sep]) and np.all(np.abs(s2 - s) <= 1e-4 * np.abs(s))


def test_ivf_store_build_is_deterministic_and_reloads(dev, tmp_path):
    """Two build_ivf_from_store runs from one seed on the card give identical
    tensors (the k-means update is a one-hot GEMM, not a float scatter-add),
    in bfloat16 and residual int8; a save and reload equals the build."""
    import numpy as np

    from haconvdr_torch.index.ivf import ARRAYS, SIDECARS
    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.parallel.sharded_ivf import (
        build_ivf_from_store,
        load_ivf_sharded,
        save_ivf_sharded,
        sharded_ivf_search,
    )

    one = make_mesh(devices=[dev])
    x = _ivf_mixture(30_000, 64)
    store = EmbeddingBlockStore(str(tmp_path / "emb"))
    store.write_block(0, x[:17_000], np.arange(17_000, dtype=np.int64))
    store.write_block(1, x[17_000:], np.arange(17_000, 30_000, dtype=np.int64))
    for dtype in ("bfloat16", "int8"):
        kw = dict(nlist=128, nprobe=16, dtype=dtype, seed=3, chunk_rows=4096)
        a, b = build_ivf_from_store(one, store, **kw), build_ivf_from_store(one, store, **kw)
        out = str(tmp_path / dtype)
        save_ivf_sharded(a, out)
        back = load_ivf_sharded(out, device=dev)
        for name in ARRAYS + SIDECARS:
            ta, tb, tc = getattr(a, name), getattr(b, name), getattr(back, name)
            assert (ta is None) == (tb is None) == (tc is None), name
            if ta is not None:
                assert ta.device.type == "cuda" and torch.equal(ta, tb) and torch.equal(ta, tc), name
        q = x[:32]
        s, i = sharded_ivf_search(one, a, q, k=20)
        s2, i2 = sharded_ivf_search(one, back, q, k=20)
        assert np.array_equal(s, s2) and np.array_equal(i, i2)


def test_head_split_attention_wrapper_on_the_card(dev, gen):
    """fused_attention over [B, H, L, d] on the card: one kernel launch,
    equal bit for bit to fused_attention_qkv of the merged projection."""
    from haconvdr_torch.ops import fused_attention as fa

    q, k, v = (torch.randn(2, 12, 128, 64, device=dev, generator=gen).bfloat16()
               for _ in range(3))
    mask = torch.ones(2, 128, dtype=torch.int32, device=dev)
    mask[1, 70:] = 0
    before = fa.COUNTS["kernel"]
    out = fa.fused_attention(q, k, v, mask)
    assert fa.COUNTS["kernel"] == before + 1 and out.shape == q.shape

    def merge(t):
        return t.transpose(1, 2).reshape(2, 128, 768)

    ref = fa.fused_attention_qkv(torch.cat([merge(q), merge(k), merge(v)], -1), mask, 12)
    assert torch.equal(out, ref.reshape(2, 128, 12, 64).transpose(1, 2))


@pytest.mark.parametrize("Q", [1, 64, 256])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_presample_seeded_kernel_equals_the_unseeded_one(dev, gen, mode, Q):
    """Row 2 with the presample threshold (auto: 16 rows a 1,024-row tile
    over 300,000 rows) against itself unseeded: scores and ids bit for
    bit, no id -1."""
    from haconvdr_torch.ops import fused_topk as ft

    p = torch.randn(300_000, 768, device=dev, generator=gen)
    q = torch.randn(Q, 768, device=dev, generator=gen)
    if mode == "int8":
        from haconvdr_torch.index.quantize import quantize_int8_torch

        p, scale = quantize_int8_torch(p)
        q = q * scale
    else:
        p = p.to(getattr(torch, mode))
    s0, i0 = ft.fused_topk_block(q, p, 299_000, 100)
    before = ft.COUNTS["kernel"]
    s, i = ft.fused_topk_block(q, p, 299_000, 100, presample=-1)
    assert ft.COUNTS["kernel"] == before + 1
    assert torch.equal(s, s0) and torch.equal(i, i0) and bool((i >= 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_index_on_four_card_slots(dev, gen, dtype):
    """ShardedIndex on four slots of one card: each non-empty shard runs
    its own v4 search (k 100) and v3 kernel (kernel="v3"), the plain path at
    k 300; through the kernels the float answers equal the one-shard index's
    bit for bit and int8 v4 the per-shard int8 x int8 model's; the plain
    path and int8 v3 (bf16-rounded folded queries) within 1e-5 of the
    per-shard GEMM, ids equal where separated."""
    from haconvdr_torch.index.quantize import quantize_queries_int8
    from haconvdr_torch.ops import topk_v4
    from haconvdr_torch.ops.topk import merge_lists
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    rows = torch.randn(300_000, 256, device=dev, generator=gen)
    q = torch.randn(64, 256, device=dev, generator=gen)
    mesh = make_mesh(devices=[dev] * 4)
    for kernel in ("v4", "v3"):
        idx = ShardedIndex(mesh, rows, dtype=dtype, kernel=kernel)
        assert [sh.passages.shape[0] for sh in idx.shards] == [131_072, 131_072, 37_856, 0]
        before = dict(topk_v4.COUNTS)
        for k in (100, 300):
            s, i = idx.search_device(q, k)
            if dtype == "int8":
                parts = []
                for sh in idx.shards[:3]:
                    q8, qs = quantize_queries_int8(q * sh.scale)
                    full = (q8.double() @ sh.passages.double().T).float() * (qs[:, None] / 127.0)
                    if k > 128 or kernel == "v3":  # bf16-rounded folded queries
                        full = (q * sh.scale).bfloat16().float() @ sh.passages.float().T
                    parts.append((full, sh.base + torch.arange(full.shape[1], device=dev)
                                  .expand_as(full).int()))
                rs, ri = merge_lists(parts, k)
            else:
                one = ShardedIndex.from_tensor(rows, dtype=dtype, kernel=kernel)
                rs, ri = one.search_device(q, k)
            if k <= 128 and (dtype != "int8" or kernel == "v4"):
                # the kernels: one fmaf chain a row, or exact integers
                assert torch.equal(s, rs) and torch.equal(i, ri)
            else:  # the plain path's GEMMs (or the v3 kernel against one) sum in another order
                rs64 = rs.double()
                gap = (rs64[:, 1:] - rs64[:, :-1]).abs() > 1e-5 * rs64[:, 1:].abs()
                one_col = torch.ones_like(gap[:, :1])
                sep = torch.cat([one_col, gap], 1) & torch.cat([gap, one_col], 1)
                assert torch.equal(i[sep], ri[sep])
                assert bool(((s.double() - rs64).abs() <= 1e-5 * rs64.abs()).all())
        if kernel == "v4":
            assert topk_v4.COUNTS["window"] - before["window"] >= 3
            assert topk_v4.COUNTS["plain"] == before["plain"]


def test_sharded_ivf_on_four_card_slots(dev, tmp_path):
    """build_ivf_from_store on four slots of one card equals the same build
    on four CPU slots (ids bit for bit, the same answers), and a 4-shard save
    reloads onto one slot and onto four with the same answers."""
    import numpy as np

    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.parallel.sharded_ivf import (
        build_ivf_from_store,
        load_ivf_sharded,
        save_ivf_sharded,
        sharded_ivf_search,
    )

    x = _ivf_mixture(30_000, 64)
    store = EmbeddingBlockStore(str(tmp_path / "emb"))
    store.write_block(0, x, np.arange(30_000, dtype=np.int64))
    kw = dict(nlist=128, nprobe=16, dtype="bfloat16", seed=3, chunk_rows=4096)
    card = build_ivf_from_store(make_mesh(devices=[dev] * 4), store, **kw)
    cpu = build_ivf_from_store(make_mesh(devices=["cpu"] * 4), store, **kw)
    q = x[:32]
    s, i = sharded_ivf_search(card.mesh, card, q, k=20)
    rs, ri = sharded_ivf_search(cpu.mesh, cpu, q, k=20)
    assert np.array_equal(i, ri) and np.all(np.abs(s - rs) <= 1e-4 * np.abs(rs))
    save_ivf_sharded(card, str(tmp_path / "ivf"))
    for n in (1, 4):
        mesh = make_mesh(devices=[dev] * n)
        back = load_ivf_sharded(str(tmp_path / "ivf"), mesh=mesh)
        s2, i2 = sharded_ivf_search(mesh, back, q, k=20)
        assert np.array_equal(s, s2) and np.array_equal(i, i2)


def test_quantize_int8_torch_equals_numpy_on_the_card(dev, gen):
    """quantize_int8_torch on the card gives quantize_int8's scales and codes
    bit for bit: the scale divides by a tensor of 127s, since torch's CUDA
    division by a Python scalar multiplies by its float32 reciprocal, an ulp
    off numpy's division at some values."""
    from haconvdr_torch.index.quantize import quantize_int8, quantize_int8_torch

    x = torch.randn(300_000, 768, device=dev, generator=gen) * torch.rand(
        768, device=dev, generator=gen)
    codes, scale = quantize_int8_torch(x)
    ref_codes, ref_scale = quantize_int8(x.cpu().numpy())
    assert torch.equal(scale.cpu(), torch.from_numpy(ref_scale))
    assert torch.equal(codes.cpu(), torch.from_numpy(ref_codes))


def _base_tower(int8: bool, dev):
    """ANCE RoBERTa-base widths (12 x 768, 12 heads, FFN 3072), random
    weights: the f32 tower, or the int8 tower with a bf16 carry."""
    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params

    cfg = ModelConfig(dtype="bfloat16" if int8 else "float32")
    params = init_params_numpy(cfg, seed=5)
    if int8:
        params = quantize_encoder_params(params)
    return AnceEncoder.from_jax_params(params, cfg, dev)


@pytest.mark.parametrize("mix", ["first_turn", "sessions"])
@pytest.mark.parametrize("int8", [False, True])
def test_packed_tower_equals_padded_on_the_card(dev, monkeypatch, int8, mix):
    """The packed inference forward (ops/pack.py) against the padded one at B
    64, L 512: first-turn lengths (6-16 tokens) and sessions-like ones
    (13-512, a full row); f32 scores within 1e-6 of the top score (cuBLAS
    picks its SGEMM by the row count, so an element may move by more),
    int8 bit for bit.  Every attention call of the packed forward gets a buffer
    whose pad positions are finite (zeros) across the 12 layers."""
    import numpy as np

    from haconvdr_torch.models import encoder as E
    from haconvdr_torch.ops import fused_attention, pack

    enc = _base_tower(int8, dev)
    rng = np.random.RandomState(11)
    B, L = 64, 512
    lens = rng.randint(6, 17, B) if mix == "first_turn" else rng.randint(13, L + 1, B)
    if mix == "sessions":
        lens[5] = L
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(3, 50265, (B, L)) * mask).astype(np.int32)
    x, m = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    kernel = fused_attention.fused_attention_qkv
    seen = []

    def checked(qkv, mask_, nh):
        seen.append((tuple(qkv.shape), bool(torch.isfinite(qkv).all())))
        return kernel(qkv, mask_, nh)

    with torch.inference_mode():
        padded = E._encode([enc], x, m)
        monkeypatch.setattr(fused_attention, "fused_attention_qkv", checked)
        packed = enc(x, m, host_mask=mask)
    torch.cuda.synchronize()
    width = pack.Plan(mask).width
    assert seen == [((B, width, 3 * 768), True)] * 12
    if int8:
        assert torch.equal(packed, padded)
    else:  # each row's scores against the padded rows, to the top score
        scores, ref = packed @ padded.T, padded @ padded.T
        err = float((scores - ref).abs().max() / ref.abs().max())
        elem = float((packed - padded).abs().max() / padded.abs().max())
        print(f"packed f32 {mix}: score error {err:.3e} of the top score, element {elem:.3e}")
        assert err <= 1e-6, (err, elem)


# -- the expert layer (ops/moe.py, csrc/moe_experts.cu) and the DeepSeek-V2
# tower.  The kernel and the plain twin both take bf16 products with f32
# sums and round the same intermediates to bf16, in another order of the
# sums: a bf16 rounding of h may flip, so outputs are held to 1% of their
# norm a row (a wrong expert, weight or row reads ~100%).


def _moe_inputs(gen, dev, T, H, I, E, logits=None):
    x = torch.randn(T, H, device=dev, generator=gen).to(torch.bfloat16)
    gate = (torch.randn(E, H, device=dev, generator=gen) * H ** -0.5).to(torch.bfloat16)
    w13 = (torch.randn(E, 2 * I, H, device=dev, generator=gen) * H ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn(E, H, I, device=dev, generator=gen) * I ** -0.5).to(torch.bfloat16)
    return x, gate, w13, w2


def _moe_close(out, ref):
    err = (out.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert float(err.max()) <= 1e-2, float(err.max())


@pytest.mark.parametrize("case", ["T1", "empty_expert", "one_expert", "ragged"])
def test_moe_kernel_matches_plain_at_the_edges(dev, gen, case):
    from haconvdr_torch.ops import moe

    T, H, I, E, k = {"T1": (1, 64, 32, 8, 2), "empty_expert": (300, 64, 32, 8, 2),
                     "one_expert": (257, 72, 40, 8, 1), "ragged": (1000, 136, 24, 24, 3)}[case]
    x, gate, w13, w2 = _moe_inputs(gen, dev, T, H, I, E)
    if case == "empty_expert":  # expert 3 can never win
        gate[3] = -gate.abs().sum(0)
        x = x.abs()
    if case == "one_expert":  # every token on expert 5
        gate.zero_()
        gate[5] = 1
        x = x.abs() + 0.1
    before = dict(moe.COUNTS)
    out = moe.routed_experts(x, gate, w13, w2, k, 1.5)
    torch.cuda.synchronize()
    assert moe.COUNTS["kernel"] == before["kernel"] + 1
    assert moe.COUNTS["assignments"] == before["assignments"] + T * k
    _moe_close(out, moe.routed_experts_plain(x, gate, w13, w2, k, 1.5))
    if case == "one_expert":
        w, e = moe.route_plain(x, gate, k)
        assert bool((e == 5).all())


def test_moe_kernel_at_the_published_widths_makes_no_host_sync(dev, gen):
    """DeepSeek-V2-Lite's expert layer (H 2048, I 1408, 64 experts, top 6) over
    4,096 tokens: one call under sync-debug "error", then the plain twin."""
    from haconvdr_torch.ops import moe

    x, gate, w13, w2 = _moe_inputs(gen, dev, 4096, 2048, 1408, 64)
    moe.routed_experts(x, gate, w13, w2, 6)  # builds the library first
    torch.cuda.synchronize()
    loads0 = sum(int(t.sum()) for t in moe.expert_loads())
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.routed_experts(x, gate, w13, w2, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _moe_close(out, moe.routed_experts_plain(x, gate, w13, w2, 6))
    # the kernel's load accumulators count its tokens; the plain twin's too
    assert sum(int(t.sum()) for t in moe.expert_loads()) == loads0 + 2 * 4096 * 6


def _tiny_decoder(dev, **kw):
    from haconvdr_torch.config import DeepseekV2Config
    from haconvdr_torch.models.deepseek_v2 import DeepseekV2Encoder

    cfg = DeepseekV2Config(**kw)
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in DeepseekV2Encoder(cfg).state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(7)
    params = {n: (torch.ones(s, device=dev) if n.endswith("norm.weight")
                  else torch.randn(s, device=dev, generator=g) * 0.05).to(torch.bfloat16)
              for n, s in shapes.items()}
    return cfg, params, DeepseekV2Encoder.from_params(params, cfg, dev)


def test_deepseek_v2_tower_on_the_card_makes_no_host_sync(dev):
    """The tower at the published widths, cut to one dense and two expert
    layers: one packed forward under sync-debug "error" with the host mask
    (no plan read back), then the same weights with the plain expert twin,
    and the float32 reference."""
    import dataclasses

    import numpy as np

    from haconvdr_torch.ops import moe, pack
    from h100_bench.reference.deepseek_v2 import Reference

    cfg, params, enc = _tiny_decoder(dev, num_hidden_layers=3)
    rng = np.random.default_rng(0)
    lens = [512, 3, 77, 1, 200, 64, 130, 9]
    mask = np.zeros((len(lens), 512), np.int64)
    for b, n in enumerate(lens):
        mask[b, :n] = 1
    ids = torch.from_numpy(rng.integers(5, cfg.vocab_size, mask.shape) * mask).to(dev)
    m = torch.from_numpy(mask).to(dev)
    with torch.inference_mode():
        enc(ids, m, host_mask=mask)  # warm: builds the library
        torch.cuda.synchronize()
        reads = pack.COUNTS["plan_reads"]
        kernel = moe.COUNTS["kernel"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = enc(ids, m, host_mask=mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert pack.COUNTS["plan_reads"] == reads and moe.COUNTS["kernel"] == kernel + 2
        enc.plain = True
        twin = enc(ids, m, host_mask=mask)
        enc.plain = False
    ref = Reference(dataclasses.asdict(cfg), params, dev).embed(
        [ids[b, :n].tolist() for b, n in enumerate(lens)])
    for got, lim in ((out, 0.08), (twin, 0.08)):
        err = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
        assert float(err.max()) <= lim, err
    assert float(((out - twin).norm(dim=-1) / twin.norm(dim=-1)).max()) <= 0.05


def test_v4_search_bf16_at_d2048_over_a_million_rows(dev, gen):
    """The v4 search in bf16 at D 2048 over 1,000,000 rows (2.048e9 elements,
    under 2^31) against the plain exact top-k of the same bf16 rows."""
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    N, D, k = 1_000_000, 2048, 100
    rows = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    for a in range(0, N, 100_000):
        rows[a:a + 100_000] = torch.randn(100_000, D, device=dev, generator=gen)
    q = torch.randn(64, D, device=dev, generator=gen)
    index = ShardedIndex.from_tensor(rows, dtype="bfloat16")
    s, i = index.search(q.cpu().numpy(), k)
    qb = q.to(torch.bfloat16).float()
    best_s = best_i = None
    for a in range(0, N, 100_000):
        sc = qb @ rows[a:a + 100_000].float().T
        ts, ti = torch.topk(sc, k, dim=1)
        ti = ti + a
        if best_s is not None:
            ts, j = torch.topk(torch.cat([best_s, ts], 1), k, dim=1)
            ti = torch.gather(torch.cat([best_i, ti], 1), 1, j)
        best_s, best_i = ts, ti
    rs, ri = best_s.cpu().numpy(), best_i.cpu().numpy()
    import numpy as np

    assert np.all(np.abs(s - rs) <= 1e-4 * np.abs(rs))
    # ids equal wherever the neighbours' scores are not within the tolerance
    gap = np.minimum(np.abs(np.diff(rs, axis=1, prepend=np.inf)),
                     np.abs(np.diff(rs, axis=1, append=-np.inf)))
    clear = gap > 2e-4 * np.abs(rs)
    assert np.array_equal(i[clear], ri[clear]) and clear.mean() > 0.5


def test_the_tower_loop_pipelines_on_the_card(dev, tmp_path, monkeypatch):
    """``parallel.sharded_encode.tower_rows`` with batches in flight: through
    ``encode_batches`` over 2 x PIPELINE_DEPTH + 3 batches the rows and ids
    come back in order, each batch's rows equal to that batch run alone and
    read back at once, each read back behind its own event; a lone batch
    (a serving dispatch) comes back in a plain copy, with no event, and the
    same rows; through ``encode_corpus`` with the tracer on, one tower.h2d,
    tower.launch and tower.wait a batch, a short last batch stored as its
    own rows."""
    import numpy as np

    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.data.loader import batch_iter
    from haconvdr_torch.index.build import encode_corpus
    from haconvdr_torch.index.store import TokenizedCorpus, TokenizedCorpusWriter
    from haconvdr_torch.models import build_tower
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.parallel.sharded_encode import PIPELINE_DEPTH, encode_batches
    from haconvdr_torch.utils.telemetry import TRACER

    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=128, num_attention_heads=2,
                           intermediate_size=256)  # head dim 64, the kernel's
    enc = build_tower(init_params_numpy(cfg, seed=5), cfg, dev)
    rng = np.random.default_rng(0)
    n, L = 2 * (2 * PIPELINE_DEPTH + 3) - 1, 24
    lens = rng.integers(1, L + 1, n)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(3, 512, (n, L)).astype(np.int32) * mask
    examples = [{"sample_id": f"q{i}", "q": ids[i], "q_mask": mask[i]} for i in range(n)]
    events = []
    event = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: events.append(1) or event(*a, **k))
    embs, got_ids = encode_batches(enc, batch_iter(examples, 2), "q", "q_mask")
    assert got_ids == [e["sample_id"] for e in examples] and embs.shape == (n, cfg.embedding_dim)
    assert len(events) == -(-n // 2)
    lone, lone_ids = encode_batches(enc, batch_iter(examples[:2], 2), "q", "q_mask")
    assert len(events) == -(-n // 2) and lone_ids == got_ids[:2]
    np.testing.assert_array_equal(lone, embs[:2])
    monkeypatch.undo()
    with torch.inference_mode():
        for b0, batch in zip(range(0, n, 2), batch_iter(examples, 2)):
            one = enc(torch.from_numpy(batch["q"]).to(dev), torch.from_numpy(batch["q_mask"]).to(dev),
                      host_mask=batch["q_mask"]).cpu().numpy()[batch["valid"] == 1]
            np.testing.assert_array_equal(embs[b0 : b0 + len(one)], one)
    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=L)
    for i in range(n):
        w.add(i, ids[i, : lens[i]].tolist())
    w.finalize()
    TRACER.start()
    try:
        store = encode_corpus(TokenizedCorpus(str(tmp_path / "c")), enc, str(tmp_path / "b"),
                              batch_size=2)
    finally:
        snap = TRACER.stop()
    batches = -(-n // 2)
    assert [len(snap.of(s)) for s in ("tower.h2d", "tower.launch", "tower.wait")] == [batches] * 3
    rows = np.concatenate([np.asarray(store.read_block(b)[0]) for b in range(store.num_blocks())])
    np.testing.assert_array_equal(rows[: n - 1], embs[: n - 1])
    assert np.abs(rows[-1] - embs[-1]).max() <= 1e-5 * np.abs(embs[-1]).max()


def test_the_tower_loop_reads_back_from_a_card_that_is_not_the_current_one(dev):
    """A tower on ``cuda:1`` while ``cuda:0`` is the current device: each
    batch is read back only once its copy off ``cuda:1`` has landed (the
    event is recorded on that card's stream).  Each batch first holds the
    card ~10 ms, so a read that did not wait would find the pinned rows
    unwritten; the rows equal each batch run alone and read back at once."""
    import numpy as np

    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.data.loader import batch_iter
    from haconvdr_torch.models import build_tower
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.parallel.sharded_encode import PIPELINE_DEPTH, encode_batches

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=128, num_attention_heads=2,
                           intermediate_size=256)
    enc = build_tower(init_params_numpy(cfg, seed=5), cfg, other)

    class Slow(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.enc = enc

        def forward(self, x, m, host_mask=None):
            with torch.cuda.device(x.device):
                torch.cuda._sleep(20_000_000)
            return self.enc(x, m, host_mask=host_mask)

    rng = np.random.default_rng(0)
    n, L = 2 * (2 * PIPELINE_DEPTH + 3), 24
    lens = rng.integers(1, L + 1, n)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(3, 512, (n, L)).astype(np.int32) * mask
    examples = [{"sample_id": f"q{i}", "q": ids[i], "q_mask": mask[i]} for i in range(n)]
    with torch.cuda.device(0):
        embs, got_ids = encode_batches(Slow(), batch_iter(examples, 2), "q", "q_mask")
    assert got_ids == [e["sample_id"] for e in examples]
    with torch.inference_mode():
        for b0, batch in zip(range(0, n, 2), batch_iter(examples, 2)):
            one = enc(torch.from_numpy(batch["q"]).to(other),
                      torch.from_numpy(batch["q_mask"]).to(other),
                      host_mask=batch["q_mask"]).cpu().numpy()[batch["valid"] == 1]
            np.testing.assert_array_equal(embs[b0 : b0 + len(one)], one)
