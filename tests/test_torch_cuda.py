"""CUDA kernels of the PyTorch port against their plain twins, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the skip is
decided in a fixture, never at import).  On a machine with a card and no
JAX, run them without the JAX-side conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances as in chip_smoke.py: attention float32 within 1e-4, bfloat16
within one bf16 ulp; top-k scores within 1e-4 relative and ids identical
(the inputs here have no near-ties).
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
