"""The v4 search of the PyTorch port (haconvdr_torch/ops/topk_v4.py) against
the JAX reference (haconvdr_tpu/ops/pallas_topk_v4.py, Pallas kernels in
interpret mode) and exact_topk_oracle.  On the CPU every wrapper runs its
plain twin; inputs are made with numpy and given to both packages.

Pass conditions: float32 scores within 1e-5 relative (summation order
only), ids identical; int8 x int8 scores are integers and equal exactly.
Where JAX orders a tie class by buffer slot, the int8 comparison holds
each id to its tie class (tests/test_pallas_topk.py:468-478); against the
oracle the port's ids are identical, ties going to the lower id.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import haconvdr_tpu.ops.pallas_topk_v4 as jv4
from haconvdr_tpu.index.quantize import quantize_int8
from haconvdr_tpu.ops.topk import exact_topk_oracle as jax_oracle
from haconvdr_torch.index.quantize import quantize_queries_int8
from haconvdr_torch.ops import fused_topk
from haconvdr_torch.ops import topk_v4 as v4

T = torch.from_numpy


def _jax_panels(q, p, n_valid, sw, p_tile=256):
    """JAX's window kernel, called as _v4_search.run_panel calls it: the
    first N / sw rows of its transposed (v1, a1, v2) panels."""
    Q, D = q.shape
    N = p.shape[0]
    n_win = p_tile // sw
    flush = 128 // n_win
    n_tiles = N // p_tile
    Wp = -(-n_tiles // flush) * flush * n_win
    kernel = functools.partial(jv4._window_top2_kernel, pt=p_tile, qt=Q, sw=sw, flush=flush)
    out_spec = pl.BlockSpec((128, Q), lambda j, *_: (j // flush, 0))
    outs = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(n_tiles,),
            in_specs=[
                pl.BlockSpec((Q, D), lambda j, *_: (0, 0)),
                pl.BlockSpec((p_tile, D), lambda j, *_: (j, 0)),
            ],
            out_specs=[out_spec] * 3,
        ),
        out_shape=[
            jax.ShapeDtypeStruct((Wp, Q), jnp.float32),
            jax.ShapeDtypeStruct((Wp, Q), jnp.int32),
            jax.ShapeDtypeStruct((Wp, Q), jnp.float32),
        ],
        interpret=True,
    )(jnp.asarray([n_valid], jnp.int32), jnp.asarray(q), jnp.asarray(p))
    return [np.asarray(o)[: N // sw] for o in outs]


@pytest.mark.parametrize(
    "n, dtype, sw, budget, want",
    [
        (2_500_608, "bfloat16", 0, 0, (256, 8)),
        (2_500_608, "float32", 0, 0, (256, 8)),
        (2_500_608, "int8", 0, 0, (256, 6)),
        (301_056, "bfloat16", 0, 0, (128, 4)),
        (2_500_608, "int8", 128, 4, (128, 4)),
        (301_056, "int8", 256, 0, (256, 6)),
    ],
)
def test_geometry_matches_jax(n, dtype, sw, budget, want):
    got = v4.resolve_select_geometry(n, getattr(torch, dtype), sw, budget)
    assert got == want == jv4.resolve_select_geometry(n, jnp.dtype(dtype), sw, budget)


@pytest.mark.parametrize(
    "Q, C, queries_fast, want",
    [(256, 11_814, True, 4), (256, 11_814, False, 4), (7, 11_814, True, 12),
     (1, 9766, False, 10), (1, 2000, False, 2), (2048, 11_814, True, 1),
     (1, 400_000, False, 391)],
)
def test_select_splits(Q, C, queries_fast, want):
    """About eight warps an SM, at most two tiles of SEL_ROWS entries a
    split."""
    assert v4.select_splits(Q, C, 132, queries_fast) == want


def test_geometry_drops_the_tpu_tiling_condition():
    # nothing is padded on the card, so 2M+ rows take sw 256 at any N
    assert v4.resolve_select_geometry(2_500_000, torch.float32) == (256, 8)
    assert jv4.resolve_select_geometry(2_500_000, jnp.float32) == (128, 4)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_valid", [2048, 1500])
def test_window_top2_matches_jax_panels(rng, dtype, n_valid):
    Q, N, D, sw = 16, 2048, 32, 128
    q = rng.randn(Q, D).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32)
    p[::37] = p[1::37]  # duplicate rows inside windows: v2 == v1, a1 the lower row
    if dtype == "int8":
        p = quantize_int8(p)[0]
        q = np.clip(np.round(q * 40), -127, 127).astype(np.int8)
    v1, a1, v2 = v4.window_top2(T(q), T(p), n_valid, sw)
    j1, ja, j2 = _jax_panels(q, p, n_valid, sw)
    assert v1.shape == (N // sw, Q)
    np.testing.assert_allclose(v1.numpy(), j1, rtol=1e-5)
    np.testing.assert_allclose(v2.numpy(), j2, rtol=1e-5)
    fin = np.isfinite(j1)
    np.testing.assert_array_equal(a1.numpy()[fin], ja[fin])
    assert np.isneginf(v1.numpy()[-(-n_valid // sw):]).all()


@pytest.mark.parametrize(
    "dtype, a_up_to, tiled",
    [(torch.float32, 16, "b"), (torch.bfloat16, 32, "b"), (torch.int8, 8, "c")],
)
def test_window_route_at_its_boundaries(dtype, a_up_to, tiled):
    """Route A (streaming) serves the small batches, up to the measured
    crossover of each dtype; above it the tiled route of the dtype."""
    for Q in (1, 2, 8, a_up_to):
        assert v4.window_route(Q, dtype) == "a"
    for Q in (a_up_to + 1, 64, 256, 4096):
        assert v4.window_route(Q, dtype) == tiled


def test_window_route_keeps_route_a_within_its_shared_memory():
    """Route A holds its group of queries in shared memory: a row too wide
    for it sends even one query to the tiled route."""
    assert v4.window_route(16, torch.float32, 1536) == "a"
    assert v4.window_route(16, torch.float32, 1537) == "b"
    assert v4.window_route(1, torch.float32, 24_576) == "a"
    assert v4.window_route(1, torch.float32, 24_577) == "b"
    assert v4.window_route(8, torch.int8, 12_288) == "a"
    assert v4.window_route(8, torch.int8, 12_289) == "c"


def _merge_triples(x, y):
    """The window kernel's merge rule on (v, a, s) tensors: the larger max
    wins, the lower row on a tie, and the loser's max joins the second
    maxima."""
    xw = (x[0] > y[0]) | ((x[0] == y[0]) & (x[1] < y[1]))
    return (torch.where(xw, x[0], y[0]), torch.where(xw, x[1], y[1]),
            torch.where(xw, torch.maximum(x[2], y[0]), torch.maximum(y[2], x[0])))


def _window_top2_by_parts(q, p, n_valid, sw, gen):
    """The window kernel's reduction, emulated: every window's rows cut
    into subsets at random (as slices, lanes and tile halves cut them), a
    partial triple folded from each subset's rows in a random order, and
    the partials merged by the rule in a shuffled order, starting from the
    window's empty triple (-inf, its first row, -inf)."""
    N = p.shape[0]
    W = -(-N // sw)
    s = q.to(torch.float64) @ p.to(torch.float64).T  # exact: integer-valued inputs
    s = torch.nn.functional.pad(s.to(torch.float32), (0, W * sw - N), value=NEG)
    rows = torch.arange(W * sw)
    s = s.masked_fill(rows[None, :] >= min(n_valid, N), NEG)
    Q = q.shape[0]
    sv = s.view(Q, W, sw)
    first = (torch.arange(W) * sw)[None, :].expand(Q, W)
    empty = (torch.full((Q, W), NEG), first.clone(), torch.full((Q, W), NEG))
    order = torch.randperm(sw, generator=gen)
    cuts = sorted(torch.randperm(sw - 1, generator=gen)[:5].add(1).tolist())
    parts = []
    for lo, hi in zip([0] + cuts, cuts + [sw]):
        t = empty
        for r in order[lo:hi].tolist():
            t = _merge_triples(t, (sv[:, :, r], first + r, torch.full((Q, W), NEG)))
        parts.append(t)
    out = empty
    for i in torch.randperm(len(parts), generator=gen).tolist():
        out = _merge_triples(out, parts[i])
    return tuple(x.T.contiguous() for x in out)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("sw", [64, 128])
@pytest.mark.parametrize("n_valid", [2048, 1500, 1000])
def test_window_reduction_by_parts_matches_plain_and_jax(rng, dtype, sw, n_valid):
    """The merge rule reduces disjoint row sets to the window triple in
    any order: held bit for bit against window_top2_plain and against
    JAX's _window_top2_kernel in interpret mode, on integer-valued inputs
    (exact scores) full of ties, with n_valid inside a window and windows
    wholly past it."""
    Q, N, D = 8, 2048, 16
    q = rng.randint(-3, 4, (Q, D)).astype(np.float32)
    p = rng.randint(-2, 3, (N, D)).astype(np.float32)
    p[1::9] = p[::9][: p[1::9].shape[0]]  # duplicate rows: ties inside windows
    if dtype == "int8":
        q, p = q.astype(np.int8), p.astype(np.int8)
    gen = torch.Generator().manual_seed(int(rng.randint(1 << 30)))
    e1, ea, e2 = _window_top2_by_parts(T(q), T(p), n_valid, sw, gen)
    r1, ra, r2 = v4.window_top2_plain(T(q), T(p), n_valid, sw)
    for got, want in ((e1, r1), (ea, ra), (e2, r2)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert np.isneginf(e1.numpy()[-(-n_valid // sw):]).all()
    assert (ea.numpy()[-(-n_valid // sw):] == (np.arange(-(-n_valid // sw), N // sw) * sw)[:, None]).all()
    j1, ja, j2 = _jax_panels(q, p, n_valid, sw)
    np.testing.assert_array_equal(e1.numpy(), j1)
    np.testing.assert_array_equal(e2.numpy(), j2)
    fin = np.isfinite(j1)
    np.testing.assert_array_equal(ea.numpy()[fin], ja[fin])


def test_select_topk_t_matches_jax_cold_and_warm(rng):
    Q, C, k = 64, 1100, 8
    s = rng.randn(C, Q).astype(np.float32)
    s[:40, 0] = np.sort(s[:, 0])[-k]  # exact ties at the k-th value
    floor = v4.warm_floor(T(s), k)
    jfloor = jv4.warm_floor(jnp.asarray(s), k)
    np.testing.assert_array_equal(floor.numpy(), np.asarray(jfloor))
    for rm0, fl in ((None, None), (jfloor, floor)):
        vs, vi = v4.select_topk_t(T(s), k, floor=fl)
        js, ji = jv4.pallas_select_topk_t(
            jnp.asarray(s), k, c_tile=256, q_sub=64, rm0=rm0, seg=256, interpret=True
        )
        np.testing.assert_array_equal(vs.numpy(), np.asarray(js))
        np.testing.assert_array_equal(vi.numpy()[1:], np.asarray(ji)[1:])
        # column 0's tie class: the port takes the lowest rows
        np.testing.assert_array_equal(vi.numpy()[0], np.argsort(-s[:, 0], kind="stable")[:k])
    assert v4.warm_floor(T(s[:256]), 8) is None  # 2 segments < k


def test_select_topk_matches_jax_and_takes_tie_ids(rng):
    Q, C, k = 64, 1000, 12
    s = rng.randn(Q, C).astype(np.float32)
    vs, vi = v4.select_topk(T(s), k)
    js, ji = jv4.pallas_select_topk(jnp.asarray(s), k, q_tile=32, c_tile=256, interpret=True)
    np.testing.assert_array_equal(vs.numpy(), np.asarray(js))
    np.testing.assert_array_equal(vi.numpy(), np.asarray(ji))
    # tie-break ids: equal scores order by the given id, not the column
    sd = np.repeat(rng.randn(Q, 125).astype(np.float32), 8, axis=1)
    ids = np.tile(np.arange(C)[::-1].astype(np.int32), (Q, 1))
    vs, vi = v4.select_topk(T(sd), k, ids=T(ids))
    for r in range(Q):
        order = sorted(range(C), key=lambda c: (-sd[r, c], ids[r, c]))[:k]
        np.testing.assert_array_equal(vi.numpy()[r], ids[r, order])
        np.testing.assert_array_equal(vs.numpy()[r], sd[r, order])


def test_select_empty_slots_are_neg_inf_minus_one():
    s = torch.full((3, 5), float("-inf"))
    s[0, 2] = 1.0
    vs, vi = v4.select_topk_t(s.T.contiguous(), 4)
    assert vi.tolist() == [[2, -1, -1, -1], [-1] * 4, [-1] * 4]
    assert torch.isneginf(vs[:, 1:]).all() and vs[0, 0] == 1.0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_rescore_windows_matches_jax(rng, dtype):
    Q, N, D, sw, B = 16, 1024, 32, 128, 4
    q = rng.randn(Q, D).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32)
    if dtype == "int8":
        p = quantize_int8(p)[0]
        q = np.clip(np.round(q * 40), -127, 127).astype(np.int8)
    win = rng.randint(0, N // sw, (Q, B)).astype(np.int32)
    got = v4.rescore_windows(T(p), T(q), T(win), sw, 1000).numpy()
    ref = np.asarray(jv4._rescore_windows(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(win), sw, interpret=True
    ))
    rows = win[:, :, None] * sw + np.arange(sw)
    valid = (rows < 1000).reshape(Q, -1)
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-5, atol=1e-5)
    assert np.isneginf(got[~valid]).all()
    win[:, 1] = -1  # an empty slot scores -inf
    got = v4.rescore_windows(T(p), T(q), T(win), sw, 1000).numpy().reshape(Q, B, sw)
    assert np.isneginf(got[:, 1]).all()


def _jax_v4(q, p, n_valid, k, **kw):
    kw.setdefault("q_tile", min(64, q.shape[0]))
    kw.setdefault("p_tile", 256)
    s, i, nf = jv4._v4_search(
        jnp.asarray(q), jnp.asarray(p), jnp.int32(n_valid), k, interpret=True, **kw
    )
    return np.asarray(s), np.asarray(i), int(nf)


@pytest.mark.parametrize("n_valid", [2048, 1500])
def test_v4_search_matches_jax_and_oracle(rng, n_valid):
    Q, N, D, k = 128, 2048, 32, 10
    q = rng.randn(Q, D).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32)
    p[n_valid:] *= 100.0  # rows past n_valid would win if they surfaced
    s, i, nf = v4.v4_search(T(q), T(p), n_valid, k, budget=16)
    js, ji, jnf = _jax_v4(q, p, n_valid, k, budget=16)
    assert int(nf) == jnf <= 16
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-5)
    os_, oi = jax_oracle(jnp.asarray(q), jnp.asarray(p[:n_valid]), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(oi))


def test_v4_search_across_jax_query_panels(rng):
    """JAX splits Q = 256 into two 128-query panels; the port has none."""
    Q, N, D, k = 256, 1024, 16, 7
    q = rng.randn(Q, D).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32)
    s, i, nf = v4.v4_search(T(q), T(p), 900, k, budget=16)
    js, ji, jnf = _jax_v4(q, p, 900, k, q_tile=128, q_panel=128, budget=16)
    assert int(nf) == jnf
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-5)


def test_v4_rescore_path_fires_within_budget(rng):
    """Planted strong pairs inside one window flag it (n_flag >= 1); the
    rescored rows make the answer exact, with no fallback."""
    Q, N, D, k = 32, 1024, 16, 8
    q = rng.randn(Q, D).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32) * 0.01
    for w in range(4):
        strong = rng.randn(D).astype(np.float32)
        p[w * 256] = strong
        p[w * 256 + 1] = strong * 0.999
    s, i, nf = v4.v4_search(T(q), T(p), N, k, budget=8)
    js, ji, jnf = _jax_v4(q, p, N, k, budget=8, q_tile=32)
    assert 1 <= int(nf) == jnf <= 8
    np.testing.assert_array_equal(i.numpy(), ji)
    before = dict(v4.COUNTS)
    s2, i2 = v4.topk_block_v4(T(q), T(p), N, k, budget=8)
    assert v4.COUNTS["v3_fallback"] == before["v3_fallback"]
    os_, oi = jax_oracle(jnp.asarray(q), jnp.asarray(p), k)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(oi))
    np.testing.assert_allclose(s2.numpy(), np.asarray(os_), rtol=1e-5)


def test_budget_overflow_falls_back_to_v3(rng):
    Q, N, D, k = 16, 2048, 8, 6
    row = rng.randn(D).astype(np.float32)
    p = np.tile(row, (N, 1))
    q = rng.randn(Q, D).astype(np.float32)
    _, _, nf = v4.v4_search(T(q), T(p), N, k)
    assert int(nf) > 4 and int(nf) == _jax_v4(q, p, N, k, q_tile=16)[2]
    before = dict(v4.COUNTS)
    v3_before = fused_topk.COUNTS["plain"]
    s, i = v4.topk_block_v4(T(q), T(p), N, k)
    assert v4.COUNTS["v3_fallback"] == before["v3_fallback"] + 1
    assert fused_topk.COUNTS["plain"] == v3_before + 1  # the v3 route ran
    # every row ties: the port returns the k lowest ids
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(k), (Q, 1)))
    np.testing.assert_allclose(s.numpy(), np.tile((q @ row)[:, None], (1, k)), rtol=1e-5)
    js, ji = jv4.pallas_topk_block_v4(
        jnp.asarray(q), jnp.asarray(p), N, k, q_tile=16, p_tile=256, interpret=True
    )
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)


def test_exact_ties_go_to_the_lower_id(rng):
    """Duplicate rows across and within windows: the v4 answer (unflagged
    maxima and rescored rows alike) equals the oracle, which takes the
    lower index, and equals the v3 route's answer."""
    Q, N, D, k = 8, 2048, 16, 12
    q = rng.randn(Q, D).astype(np.float32)
    p = np.repeat(rng.randn(N // 4, D).astype(np.float32), 4, axis=0)
    p[1000:1004] = p[10:14]  # the same values in windows 0 and 7
    s, i = v4.topk_block_v4(T(q), T(p), N, k, budget=32)
    os_, oi = jax_oracle(jnp.asarray(q), jnp.asarray(p), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(oi))
    s3, i3 = fused_topk.fused_topk_block(T(q), T(p), N, k)
    np.testing.assert_array_equal(i.numpy(), i3.numpy())
    np.testing.assert_array_equal(s.numpy(), s3.numpy())


def test_bf16_passages_match_jax(rng):
    Q, N, D, k = 64, 2048, 32, 10
    q = rng.randn(Q, D).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32)
    s, i = v4.topk_block_v4(T(q), T(p).to(torch.bfloat16), N, k, budget=16)
    js, ji = jv4.pallas_topk_block_v4(
        jnp.asarray(q), jnp.asarray(p, jnp.bfloat16), N, k,
        q_tile=64, p_tile=256, budget=16, interpret=True,
    )
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def _int8_case(rng, Q, N, D):
    emb = rng.randn(N, D).astype(np.float32)
    codes, scale = quantize_int8(emb)
    qf = rng.randn(Q, D).astype(np.float32) * scale[None, :]
    q8, q_scale = quantize_queries_int8(T(qf))  # one set of codes for both packages
    return codes, qf, q8.numpy(), q_scale


@pytest.mark.parametrize("N, k", [(8192, 4), (1024, 10)])  # fast path; budget overflow
def test_int8_through_both_packages(rng, N, k):
    Q, D = 64, 32
    codes, qf, q8, q_scale = _int8_case(rng, Q, N, D)
    s, i, nf = v4.v4_search(T(q8), T(codes), N, k, budget=8)
    js, ji, jnf = _jax_v4(q8, codes, N, k, budget=8)
    assert int(nf) == jnf
    full_int = q8.astype(np.int64) @ codes.astype(np.int64).T
    if jnf <= 8:
        np.testing.assert_array_equal(s.numpy(), js)  # integer scores
        for r in range(Q):  # JAX orders a tie class by buffer slot
            np.testing.assert_array_equal(full_int[r, i.numpy()[r]], full_int[r, ji[r]])
    # the port's full answer (v4, or the v3 fallback) against the oracle:
    # ids identical at every position, scores bit-identical
    s2, i2 = v4.topk_block_v4(T(qf), T(codes), N, k, budget=8)
    order = np.lexsort((np.tile(np.arange(N), (Q, 1)), -full_int), axis=1)[:, :k]
    np.testing.assert_array_equal(i2.numpy(), order)
    want = T(np.take_along_axis(full_int, order, 1).astype(np.float32)) * (q_scale[:, None] / 127.0)
    np.testing.assert_array_equal(s2.numpy(), want.numpy())


def test_fewer_windows_than_k(rng):
    """W < k: v_k bounds nothing, every window with a second row flags."""
    Q, N, D, k = 4, 300, 8, 20
    q = rng.randn(Q, D).astype(np.float32)
    p = rng.randn(N, D).astype(np.float32)
    s, i = v4.topk_block_v4(T(q), T(p), N, k)
    os_, oi = jax_oracle(jnp.asarray(q), jnp.asarray(p), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(oi))
    s, i = v4.topk_block_v4(T(q), T(p), 7, k)  # fewer valid rows than k
    assert (i.numpy()[:, 7:] == -1).all() and np.isneginf(s.numpy()[:, 7:]).all()


def test_v4_search_takes_the_kernels_dtype():
    """v4_search scores queries already in the passages' dtype; the
    quantization of float queries lives in topk_block_v4 alone."""
    q = torch.zeros(2, 8)
    p = torch.zeros(256, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="passages' dtype"):
        v4.v4_search(q, p, 256, 4)


# ---------------------------------------------------------------------------
# the split select (csrc/topk_v4.cu, select_kernel): an emulation in torch
# ---------------------------------------------------------------------------

def _split_select(scores, k, floor=None, ids=None, splits=3, rows=v4.SEL_ROWS):
    """The select kernel's algorithm on a [Q, C] view: each of ``splits``
    runs of entries walked ``rows`` at a time, keeping a running top k
    (score desc, id asc) and, once more than k entries were admitted, the
    k-th score as the admission bound of later steps (ties with it stay
    in); then the top k of the splits' [Q, splits * k] candidates.  The
    top k of one step is select_plain's."""
    Q, C = scores.shape
    idv = torch.arange(C, dtype=torch.int32)[None, :].expand(Q, -1) if ids is None else ids
    thr = torch.full((Q,), NEG, dtype=torch.float32) if floor is None else floor
    per = -(-C // splits)
    kk = min(k, C)
    cand_s, cand_i = [], []
    for sp in range(splits):
        run_s = torch.full((Q, 0), NEG)
        run_i = torch.full((Q, 0), -1, dtype=torch.int32)
        lo = torch.full((Q,), NEG)
        end = min(C, (sp + 1) * per)
        for c0 in range(sp * per, end, rows):
            s = scores[:, c0:min(c0 + rows, end)]
            admit = (s > thr[:, None]) & (s >= lo[:, None])
            all_s = torch.cat([run_s, s.masked_fill(~admit, NEG)], 1)
            all_i = torch.cat([run_i, idv[:, c0:min(c0 + rows, end)]], 1)
            run_s, run_i = v4.select_plain(all_s, kk, None, all_i)
            more = (all_s > NEG).sum(1) > kk
            lo = torch.where(more, run_s[:, -1], lo)
        pad = kk - run_s.shape[1]
        cand_s.append(torch.nn.functional.pad(run_s, (0, pad), value=NEG))
        cand_i.append(torch.nn.functional.pad(run_i, (0, pad), value=-1))
    return v4.select_plain(torch.cat(cand_s, 1), kk, None, torch.cat(cand_i, 1))


NEG = float("-inf")


def _both(s_t, k, floor=None, ids_t=None, **kw):
    """(select_plain, the emulation) on the [Q, C] view of [C, Q] scores."""
    ids = None if ids_t is None else ids_t.T
    return v4.select_plain(s_t.T, k, floor, ids), _split_select(s_t.T, k, floor, ids, **kw)


def _assert_same(a, b):
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


@pytest.mark.parametrize("k", [1, 8, 100])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("layout", ["t", "rows"])
def test_split_select_matches_plain_and_jax(rng, layout, warm, k):
    Q, C = 16, 2000
    s = rng.randn(C, Q).astype(np.float32)
    floor = jfloor = None
    if warm:  # warm_floor where C has k segments, else a floor below the k-th value
        floor = v4.warm_floor(T(s), k)
        if floor is None:
            floor = T(np.sort(s, axis=0)[-(k + 50)])
        jfloor = jnp.asarray(floor.numpy())
    splits = 3  # tiles of SEL_ROWS: 667 entries a split, two steps each
    plain, emu = _both(T(s), k, floor, splits=splits)
    _assert_same(emu, plain)
    _assert_same(emu, _both(T(s), k, floor, splits=7, rows=128)[1])
    if layout == "t":
        js, ji = jv4.pallas_select_topk_t(
            jnp.asarray(s), k, c_tile=256, q_sub=64, rm0=jfloor, seg=256, interpret=True
        )
    else:
        if warm:  # pallas_select_topk takes no floor: it admits everything
            emu = _split_select(T(s.T.copy()), k, None, None, splits=splits)
        js, ji = jv4.pallas_select_topk(jnp.asarray(s.T.copy()), k, q_tile=32, c_tile=256,
                                        interpret=True)
    np.testing.assert_array_equal(emu[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(emu[1].numpy(), np.asarray(ji))


@pytest.mark.parametrize("k", [1, 8, 100])
@pytest.mark.parametrize("layout", ["t", "rows"])
def test_split_select_tie_class_straddles_splits(rng, layout, k):
    """The k-th score's tie class spans every split boundary and step: each
    split keeps its lowest ids, and the merge the lowest of all."""
    Q, C = 8, 1500
    s = rng.randn(C, Q).astype(np.float32)
    s[200:1300:3] = 5.0  # 367 entries of one value, ahead of everything else
    s[700, :] = 6.0
    ids = None
    if layout == "rows":  # tie-break ids that disagree with the position
        ids = T(np.tile(rng.permutation(C).astype(np.int32)[:, None], (1, Q)))
    plain, emu = _both(T(s), k, None, ids, splits=4, rows=128)
    _assert_same(emu, plain)
    _assert_same(_both(T(s), k, None, ids, splits=5)[1], plain)
    idv = np.arange(C) if ids is None else ids.numpy()[:, 0]
    tied = np.sort(idv[200:1300:3])[: k - 1]
    assert plain[1].numpy()[0, 0] == idv[700]
    np.testing.assert_array_equal(plain[1].numpy()[:, 1:], np.tile(tied, (Q, 1)))
    if layout == "t":  # JAX holds the values; its tie order is by buffer slot
        js, _ = jv4.pallas_select_topk_t(jnp.asarray(s), k, c_tile=256, q_sub=64, seg=256,
                                         interpret=True)
        np.testing.assert_array_equal(emu[0].numpy(), np.asarray(js))


@pytest.mark.parametrize("k", [1, 8, 100])
@pytest.mark.parametrize("layout", ["t", "rows"])
def test_split_select_empty_and_floored_splits(rng, layout, k):
    """Whole splits all -inf, or all at or below the floor: they give only
    empty slots and change nothing."""
    Q, C = 8, 2400
    s = rng.randn(C, Q).astype(np.float32)
    s[:800] = NEG  # the first split
    s[800:1600] = np.minimum(s[800:1600], -3.0)  # the second, under the floor
    floor = T(np.full(Q, -3.0, np.float32))
    ids = None
    if layout == "rows":  # tie-break ids: the answer's ids are those of rows >= 1600
        ids = T(np.tile(rng.permutation(C).astype(np.int32)[:, None], (1, Q)))
    plain, emu = _both(T(s), k, floor, ids, splits=3)
    _assert_same(emu, plain)
    _assert_same(_both(T(s), k, floor, ids, splits=6, rows=128)[1], plain)
    assert (plain[0].numpy() > -3.0).all()
    idv = np.arange(C) if ids is None else ids.numpy()[:, 0]
    assert np.isin(plain[1].numpy(), idv[1600:]).all()
    if layout == "t":
        js, ji = jv4.pallas_select_topk_t(jnp.asarray(s), k, c_tile=256, q_sub=64,
                                          rm0=jnp.asarray(floor.numpy()), seg=256,
                                          interpret=True)
        np.testing.assert_array_equal(emu[0].numpy(), np.asarray(js))
        np.testing.assert_array_equal(emu[1].numpy(), np.asarray(ji))


@pytest.mark.parametrize("k", [1, 8, 100])
@pytest.mark.parametrize("layout", ["t", "rows"])
def test_split_select_fewer_than_k_valid(rng, layout, k):
    """Fewer valid entries than k in all: they come first, ordered, and
    the rest are (-inf, -1)."""
    Q, C = 8, 1200
    s = np.full((C, Q), NEG, np.float32)
    n_valid = max(0, k - 3) if k > 1 else 0
    pos = rng.choice(C, n_valid, replace=False)
    s[pos] = rng.randn(n_valid, Q).astype(np.float32)
    plain, emu = _both(T(s), k, None, splits=4, rows=128)
    _assert_same(emu, plain)
    assert (plain[1].numpy()[:, n_valid:] == -1).all()
    assert np.isneginf(plain[0].numpy()[:, n_valid:]).all()
    assert np.isfinite(plain[0].numpy()[:, :n_valid]).all()
    if n_valid:  # JAX's valid slots hold the same entries
        if layout == "t":
            js, ji = jv4.pallas_select_topk_t(jnp.asarray(s), k, c_tile=256, q_sub=64,
                                              seg=256, interpret=True)
        else:
            js, ji = jv4.pallas_select_topk(jnp.asarray(s.T.copy()), k, q_tile=32, c_tile=256,
                                            interpret=True)
        np.testing.assert_array_equal(emu[0].numpy(), np.asarray(js))
        np.testing.assert_array_equal(emu[1].numpy()[:, :n_valid], np.asarray(ji)[:, :n_valid])
