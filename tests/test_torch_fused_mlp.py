"""The fused int8 MLP block of the PyTorch port (haconvdr_torch/ops/fused_mlp.py)
against the JAX package's Pallas kernel (haconvdr_tpu/ops/fused_mlp.py)
run in interpret mode, and the int8 dense against the JAX ``_dense``, on
the same numpy inputs (H 256, I 512, 256 rows).

Tolerances: the int8 dense is bit-identical (exact int32 sums, the same
float32 dequantization).  The MLP's y meets the JAX package's own bounds
for its kernel (tests/test_fused_mlp.py: rtol 2**-6, atol 0.07, fewer
than 2e-3 of positions past 2**-6 (1 + |ref|)); XLA:CPU keeps some
bfloat16 intermediates in float32 (``xla_allow_excess_precision``) where
the port rounds them as the kernel contract says, so codes may differ by
up to 2 where y differs.  yq and ys are exactly ``quantize_rows`` of the
port's own y.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.models.encoder import _dense
from haconvdr_tpu.ops.fused_mlp import fused_mlp_block as jax_fused_mlp_block
from haconvdr_torch.index.quantize import quantize_rows
from haconvdr_torch.ops import fused_mlp as fm

H, I, ROWS = 256, 512, 256


def _quant_params(rng, in_dim, out_dim):
    """JAX layout [in, out] int8 codes, per-out-channel scale, bias."""
    w = rng.standard_normal((in_dim, out_dim), dtype=np.float32) * 0.05
    ws = np.abs(w).max(axis=0)
    k = np.clip(np.round(w / ws * 127.0), -127, 127).astype(np.int8)
    return k, (ws / 127.0).astype(np.float32), np.linspace(-0.1, 0.1, out_dim, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def mlp_case():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((ROWS, H), dtype=np.float32) * 2.0).astype(jnp.bfloat16)
    xf = np.asarray(x, np.float32)
    xs = np.maximum(np.abs(xf).max(-1, keepdims=True), 1e-30).astype(np.float32)
    xq = np.clip(np.round(xf / xs * 127.0), -127, 127).astype(np.int8)
    p1, p2 = _quant_params(rng, H, I), _quant_params(rng, I, H)
    lns = rng.standard_normal(H, dtype=np.float32) * 0.3 + 1.0
    lnb = rng.standard_normal(H, dtype=np.float32) * 0.1
    return dict(xf=xf, xq=xq, xs=xs, p1=p1, p2=p2, lns=lns, lnb=lnb, jx=x)


def _torch_args(c):
    (k1, s1, b1), (k2, s2, b2) = c["p1"], c["p2"]
    return (
        _t(c["xf"]).bfloat16(), _t(c["xq"]), _t(c["xs"]),
        _t(k1.T), _t(s1), _t(b1), _t(k2.T), _t(s2), _t(b2), _t(c["lns"]), _t(c["lnb"]),
    )


def test_plain_twin_matches_jax_fused_mlp_block(mlp_case):
    c = mlp_case
    (k1, s1, b1), (k2, s2, b2) = c["p1"], c["p2"]
    jy, jq, js = jax_fused_mlp_block(
        c["jx"], *map(jnp.asarray, (c["xq"], c["xs"], k1, s1, b1, k2, s2, b2, c["lns"], c["lnb"])),
        eps=1e-12, out_dtype=jnp.bfloat16, interpret=True,
    )
    y, yq, ys = fm.fused_mlp_block_plain(*_torch_args(c), eps=1e-12)
    assert y.dtype == torch.bfloat16 and yq.dtype == torch.int8 and ys.shape == (ROWS, 1)
    g, w = y.float().numpy(), np.asarray(jy, np.float32)
    np.testing.assert_allclose(g, w, rtol=2.0**-6, atol=0.07)
    assert (np.abs(g - w) > 2.0**-6 * (1.0 + np.abs(w))).mean() < 2e-3
    own_q, own_s = quantize_rows(y)
    assert torch.equal(yq, own_q) and torch.equal(ys, own_s)
    assert np.abs(yq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 2
    np.testing.assert_allclose(ys.numpy(), np.asarray(js), rtol=2.0**-7)


@pytest.mark.parametrize("prequant", [False, True])
@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_int8_dense_matches_jax_dense(mlp_case, prequant, out_dtype):
    c = mlp_case
    k1, s1, b1 = c["p1"]
    p = {"kernel": jnp.asarray(k1), "kernel_scale": jnp.asarray(s1), "bias": jnp.asarray(b1)}
    jdt = None if out_dtype is None else jnp.bfloat16
    pq = (jnp.asarray(c["xq"]), jnp.asarray(c["xs"])) if prequant else None
    ref = np.asarray(_dense(c["jx"], p, jnp.bfloat16, out_dtype=jdt, prequant=pq), np.float32)
    x = _t(c["xf"]).bfloat16()
    xq, xs = (_t(c["xq"]), _t(c["xs"])) if prequant else quantize_rows(x)
    y = fm.int8_dense(xq, xs, _t(k1.T), _t(s1), _t(b1))
    if out_dtype is not None:
        y = y.to(torch.bfloat16)
    np.testing.assert_array_equal(y.float().numpy(), ref)


def test_int8_dense_keeps_leading_axes():
    rng = np.random.default_rng(1)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 3, 64), dtype=np.int8))
    xs = torch.rand(2, 3, 1) + 0.5
    w = torch.from_numpy(rng.integers(-127, 128, (40, 64), dtype=np.int8))
    y = fm.int8_dense(xq, xs, w, torch.ones(40), torch.zeros(40))
    assert y.shape == (2, 3, 40)
    want = (xq.long().reshape(6, 64) @ w.long().T).float() * (xs.reshape(6, 1) / 127.0)
    torch.testing.assert_close(y.reshape(6, 40), want, rtol=1e-6, atol=0)


def test_cpu_tensors_take_the_plain_twin_and_supported_widths(mlp_case):
    fm.COUNTS.update(kernel=0, plain=0)
    before = dict(fm.COUNTS)  # the split mode's counts stay as they were
    y = fm.fused_mlp_block(*_torch_args(mlp_case), eps=1e-12)
    assert fm.COUNTS == {**before, "kernel": 0, "plain": 1}
    ref = fm.fused_mlp_block_plain(*_torch_args(mlp_case), eps=1e-12)
    for a, b in zip(y, ref):
        assert torch.equal(a, b)
    # the kernels' widths: H % 64 up to 1024, I % 64 up to exact int32 sums;
    # 96 KB of shared memory a product block at every width
    assert fm.fused_mlp_supported(768, 3072) and fm.fused_mlp_supported(1024, 4096)
    assert fm.smem_bytes(768, 3072) == 98_304 == fm.smem_bytes(1024, 8192)
    assert fm.scratch_bytes_per_row(768, 3072) == 10_760
    assert not fm.fused_mlp_supported(32, 64) and not fm.fused_mlp_supported(96, 256)
    assert not fm.fused_mlp_supported(1024, 2**17 + 64)  # int32 sums


# -- the int8 dense of Int8Linear (haconvdr_torch/ops/int8_dense.py): the plain
# twin the CUDA kernels are held to, bit for bit


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("prequant", [False, True])
@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_int8_dense_twin_is_the_composition_and_jaxs_dense(mlp_case, out_dtype, prequant,
                                                            x_dtype):
    """``int8_dense_plain`` (and ``int8_dense`` on CPU tensors, which takes
    it) equals the composition it replaces (``quantize_rows``,
    ``fused_mlp.int8_dense``, the cast) and JAX's ``_dense``, bit for bit,
    from bf16 rows (the bf16-carry tower) and f32 rows (the f32 carry)."""
    from haconvdr_torch.ops import int8_dense as idn

    c = mlp_case
    k1, s1, b1 = c["p1"]
    p = {"kernel": jnp.asarray(k1), "kernel_scale": jnp.asarray(s1), "bias": jnp.asarray(b1)}
    jx = c["jx"] if x_dtype == "bfloat16" else jnp.asarray(c["xf"])
    jdt = None if out_dtype is None else jnp.bfloat16
    x = _t(c["xf"]).to(getattr(torch, x_dtype))
    pq = (_t(c["xq"]), _t(c["xs"])) if prequant else None
    jpq = (jnp.asarray(c["xq"]), jnp.asarray(c["xs"])) if prequant else None
    ref = np.asarray(_dense(jx, p, jx.dtype, out_dtype=jdt, prequant=jpq), np.float32)
    tdt = None if out_dtype is None else torch.bfloat16
    xq, xs = pq if prequant else quantize_rows(x)
    comp = fm.int8_dense(xq, xs, _t(k1.T), _t(s1), _t(b1))
    comp = comp if tdt is None else comp.to(tdt)
    before = dict(idn.COUNTS)
    twin = idn.int8_dense_plain(x, _t(k1.T), _t(s1), _t(b1), pq, tdt)
    routed = idn.int8_dense(x, _t(k1.T), _t(s1), _t(b1), pq, tdt)
    assert idn.COUNTS == {**before, "plain": before["plain"] + 2}
    assert twin.dtype == (tdt or torch.float32) and twin.shape == (ROWS, I)
    assert torch.equal(twin, comp) and torch.equal(routed, comp)
    np.testing.assert_array_equal(twin.float().numpy(), ref)


@pytest.mark.parametrize("K, N, ok", [
    (768, 2304, True), (768, 768, True), (3072, 768, True), (768, 3072, True),
    (768, 1152, True), (768, 576, True), (64, 64, True), (131_072, 768, True),
    (96, 768, False), (768, 100, False), (32, 768, False), (768, 0, False),
    (131_136, 768, False),
])
def test_int8_dense_supported_widths(K, N, ok):
    """The kernels' widths: K % 64 up to exact int32 sums (131,072), N % 64
    (a tp rank's QKV columns 1,152 and 576 among them), any row count."""
    from haconvdr_torch.ops import int8_dense as idn

    assert idn.int8_dense_supported(K, N) is ok


def test_int8_dense_refuses_a_device_it_has_no_route_for():
    from haconvdr_torch.ops import int8_dense as idn

    x = torch.zeros(4, 64, device="meta")
    w = torch.zeros(64, 64, dtype=torch.int8, device="meta")
    v = torch.zeros(64, device="meta")
    with pytest.raises(ValueError):
        idn.int8_dense(x, w, v, v)
