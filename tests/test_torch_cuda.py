"""CUDA kernels of the PyTorch port against their plain twins, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the skip is
decided in a fixture, never at import).  On a machine with a card and no
JAX, run them without the JAX-side conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances as in chip_smoke.py: attention float32 within 1e-4, bfloat16
within one bf16 ulp; top-k scores within 1e-4 relative and ids identical
(the inputs here have no near-ties).  int8 x int8 scores are exact
integers: equal, and ids identical at every position.  The rescore
kernel equals the window kernel bit for bit (one arithmetic for both).
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_rescore_equals_window_kernel_bit_for_bit(dev, gen, dtype):
    from haconvdr_torch.ops import topk_v4 as v4

    q, p = _v4_inputs(gen, dev, dtype)
    sw, B = 256, 8
    v1, a1, v2 = v4.window_top2(q, p, 49_000, sw)
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


@pytest.mark.parametrize(
    "x_dtype, res, quant, H, out_dtype",
    [
        (torch.bfloat16, True, True, 768, torch.bfloat16),   # attention residual
        (torch.float32, False, True, 768, torch.bfloat16),   # embeddings
        (torch.bfloat16, True, False, 768, torch.bfloat16),  # row 8
        (torch.bfloat16, False, False, 256, torch.float32),
        (torch.float32, True, True, 96, torch.float32),
    ],
)
def test_fused_ln_kernel_matches_plain(dev, gen, x_dtype, res, quant, H, out_dtype):
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.ops import fused_ln as fl

    rows = 1003
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


def _quant_weight(gen, dev, out_dim, in_dim):
    """[out, in] int8 codes and per-out-channel kernel_scale, as
    quantize_encoder_params makes them."""
    w = torch.randn(out_dim, in_dim, device=dev, generator=gen) * 0.05
    s = w.abs().amax(dim=1)
    return torch.clamp(torch.round(w / s[:, None] * 127.0), -127, 127).to(torch.int8), s / 127.0


@pytest.mark.parametrize("rows, H, I", [(1003, 768, 3072), (37, 256, 512)])
def test_fused_mlp_kernel_matches_plain(dev, gen, rows, H, I):
    from haconvdr_torch.index.quantize import quantize_rows
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


def _bf16_ulp_of_max(t):
    import math

    return 2.0 ** (math.floor(math.log2(float(t.float().abs().max()))) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [77, 512])
def test_flash_attention_kernels_match_plain(dev, gen, dtype, rate, L):
    """Rows 11-12: forward and dqkv against the plain twins on the same
    seed words: float32 within 1e-5, bfloat16 within one bf16 ulp of the
    largest magnitude."""
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
    step = make_train_step(dev, cfg, tcfg, opt)
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
