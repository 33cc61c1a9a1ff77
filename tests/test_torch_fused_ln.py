"""The fused (residual +) LayerNorm (+ int8 quantization) of the PyTorch port
(haconvdr_torch/ops/fused_ln.py) against the JAX package's Pallas kernel
(haconvdr_tpu/ops/fused_ln.py) run in interpret mode, on the same numpy
inputs (H 128/256, 256 rows).

Tolerances:
* no residual or a float32 residual: y within one bf16 ulp
  (2**-7 |ref|), at under 0.1% of positions (the same float32 ops; a
  summation-order difference in the statistics can flip a rounding);
* with a bfloat16 residual: the port rounds x + r to bfloat16, as the
  kernel contract says; XLA:CPU keeps the float32 sum
  (``xla_allow_excess_precision``), so y differs by the effect of one
  bf16 rounding of the LayerNorm input: within 2**-7 (1 + |ref|)
  (measured 6.3e-3); the scales within 2**-7 relative and the codes
  within 2;
* always: yq and ys are exactly ``quantize_rows`` of the port's own y.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.models.encoder import _layer_norm
from haconvdr_tpu.ops import fused_ln as jfl
from haconvdr_torch.index.quantize import quantize_rows
from haconvdr_torch.ops import fused_ln as fl

ROWS = 256


def _inputs(rng, H, x_dtype, res_dtype):
    x = (rng.standard_normal((ROWS, H), dtype=np.float32) * 3.0)
    r = None if res_dtype is None else rng.standard_normal((ROWS, H), dtype=np.float32)
    scale = rng.standard_normal(H, dtype=np.float32) * 0.5 + 1.0
    bias = rng.standard_normal(H, dtype=np.float32) * 0.1
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    jx = jnp.asarray(x).astype(jdt[x_dtype])
    jr = None if r is None else jnp.asarray(r).astype(jdt[res_dtype])
    tx = torch.from_numpy(x).to(x_dtype)
    tr = None if r is None else torch.from_numpy(r).to(res_dtype)
    return (jx, jr, jnp.asarray(scale), jnp.asarray(bias)), (
        tx, tr, torch.from_numpy(scale), torch.from_numpy(bias)
    )


def _f32(a):
    return np.asarray(a, np.float32)


CASES = [  # (H, x dtype, residual dtype)
    (256, torch.bfloat16, None),
    (128, torch.float32, None),  # embeddings: float32 input
    (256, torch.bfloat16, torch.bfloat16),
    (128, torch.float32, torch.float32),
]


def _check_y(y, ref, res_dtype):
    y, ref = _f32(y), _f32(ref)
    d = np.abs(y - ref)
    if res_dtype != torch.bfloat16:
        assert (d <= 2.0**-7 * np.abs(ref)).all(), d.max()
        assert (d > 0).mean() < 1e-3
    else:
        assert (d <= 2.0**-7 * (1 + np.abs(ref))).all(), d.max()


@pytest.mark.parametrize("H, x_dtype, res_dtype", CASES)
def test_plain_twin_matches_jax_fused_residual_ln(H, x_dtype, res_dtype):
    rng = np.random.default_rng(H + (res_dtype is not None))
    j, t = _inputs(rng, H, x_dtype, res_dtype)
    ref = jfl.fused_residual_ln(*j, eps=1e-5, out_dtype=jnp.bfloat16, interpret=True)
    y = fl.fused_residual_ln_plain(*t, eps=1e-5, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == t[0].shape
    _check_y(y.float().numpy(), ref, res_dtype)


@pytest.mark.parametrize("H, x_dtype, res_dtype", CASES)
def test_plain_twin_matches_jax_fused_residual_ln_quant(H, x_dtype, res_dtype):
    rng = np.random.default_rng(10 + H + (res_dtype is not None))
    j, t = _inputs(rng, H, x_dtype, res_dtype)
    jy, jq, js = jfl.fused_residual_ln_quant(
        *j, eps=1e-5, out_dtype=jnp.bfloat16, interpret=True
    )
    y, yq, ys = fl.fused_residual_ln_quant_plain(*t, eps=1e-5, out_dtype=torch.bfloat16)
    assert yq.dtype == torch.int8 and ys.dtype == torch.float32 and ys.shape == (ROWS, 1)
    _check_y(y.float().numpy(), jy, res_dtype)
    own_q, own_s = quantize_rows(y)
    assert torch.equal(yq, own_q) and torch.equal(ys, own_s)
    rel = np.abs(ys.numpy() - np.asarray(js)) / np.asarray(js)
    assert rel.max() <= 2.0**-7
    assert np.abs(yq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 2


def test_layer_norm_matches_the_jax_encoder_layer_norm():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 96), dtype=np.float32) * 2
    w = rng.standard_normal(96, dtype=np.float32)
    b = rng.standard_normal(96, dtype=np.float32)
    ref = _layer_norm(jnp.asarray(x), {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, 1e-12)
    got = fl.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_quantize_rows_matches_the_jax_dense_quantization():
    """quantize_rows is _dense's dynamic per-token quantization
    (haconvdr_tpu/models/encoder.py:132-136), bit for bit."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((3, 7, 64), dtype=np.float32) * 3).astype(jnp.bfloat16)
    xf = x.astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-30)
    xq = jnp.clip(jnp.round(xf / xs * 127.0), -127, 127).astype(jnp.int8)
    q, s = quantize_rows(torch.from_numpy(np.array(xf)).bfloat16())
    np.testing.assert_array_equal(q.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(xs))
    zq, zs = quantize_rows(torch.zeros(2, 8))  # all-zero rows: scale 1e-30, codes 0
    assert not zq.any() and torch.equal(zs, torch.full((2, 1), 1e-30))


def test_cpu_tensors_take_the_plain_twins():
    for key in fl.COUNTS:
        fl.COUNTS[key] = 0
    x = torch.randn(5, 64)
    w, b = torch.ones(64), torch.zeros(64)
    y = fl.fused_residual_ln(x, x, w, b, 1e-5)
    y2, _, _ = fl.fused_residual_ln_quant(x, None, w, b, 1e-5, torch.bfloat16)
    assert y.dtype == torch.float32 and y2.dtype == torch.bfloat16
    assert fl.COUNTS == {"ln": 0, "ln_quant": 0, "plain": 2}
    torch.testing.assert_close(y, fl.layer_norm(x + x, w, b, 1e-5), rtol=0, atol=0)
