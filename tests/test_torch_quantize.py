"""int8 quantization of the PyTorch port (haconvdr_torch/index/quantize.py)
against the shared numpy scheme (haconvdr_tpu/index/quantize.py) and the
per-query expression of haconvdr_tpu/ops/pallas_topk_v4.py:855-861.

Pass conditions: index codes and scales identical to ``quantize_int8``
(all-zero dimensions and .5 ties included); query codes identical to the
numpy expression except, at most, one code where ``q / q_scale * 127``
lies within 1e-6 of a .5 boundary (the division may round either way
there); requantization identical to the JAX accumulator's expression.
"""

import numpy as np
import pytest
import torch

import haconvdr_tpu.index.quantize as jq
from haconvdr_torch.index import quantize as tq


def test_numpy_functions_are_the_shared_ones():
    assert tq.quantize_int8 is jq.quantize_int8
    assert tq.dequantize_int8 is jq.dequantize_int8


@pytest.mark.parametrize("shape", [(300, 16), (7, 64), (70_000, 4)])
def test_index_codes_and_scales_equal_numpy(rng, shape):
    emb = (rng.randn(*shape) * rng.uniform(0.1, 10, shape[1])).astype(np.float32)
    emb[:, 1] = 0.0  # an all-zero dimension: scale 1, codes 0
    codes, scale = tq.quantize_int8_torch(torch.from_numpy(emb))
    ref_codes, ref_scale = jq.quantize_int8(emb)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), ref_scale)
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    assert scale[1] == 1.0 and not codes[:, 1].any()


def test_index_codes_round_half_to_even():
    # amax 127 per dim -> scale exactly 1, so the codes are round(x)
    emb = np.array([[127.0, 0.5], [1.5, 2.5], [-2.5, -127.0], [-0.5, 3.5]], np.float32)
    codes, scale = tq.quantize_int8_torch(torch.from_numpy(emb))
    np.testing.assert_array_equal(scale.numpy(), [1.0, 1.0])
    np.testing.assert_array_equal(codes.numpy(), [[127, 0], [2, 2], [-2, -127], [0, 4]])
    np.testing.assert_array_equal(codes.numpy(), jq.quantize_int8(emb)[0])


@pytest.mark.parametrize("D", [16, 768])
def test_query_codes_match_the_numpy_expression(rng, D):
    qf = (rng.randn(64, D) * rng.uniform(0.01, 5, (64, 1))).astype(np.float32)
    qf[3] = 0.0  # an all-zero query: q_scale 1e-30, codes 0
    q8, q_scale = tq.quantize_queries_int8(torch.from_numpy(qf))
    ref_scale = np.maximum(np.abs(qf).max(axis=1), np.float32(1e-30))
    x = qf / ref_scale[:, None] * np.float32(127.0)
    ref = np.clip(np.round(x), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q_scale.numpy(), ref_scale)
    diff = q8.numpy().astype(np.int32) - ref
    near_half = np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-6
    assert np.abs(diff).max() <= 1
    assert not (diff != 0)[~near_half].any()
    assert not q8[3].any()
    assert q8.abs().max() == 127  # each query's largest element maps to +-127


def test_requantize_matches_the_accumulator_expression(rng):
    """encode_int8_torch is the int8 super-block insert
    (haconvdr_tpu/ops/topk.py:353-367): clip(round(x * factor))."""
    codes, scale = jq.quantize_int8(rng.randn(200, 8).astype(np.float32))
    target = scale * np.float32(1.7)
    factor = scale / target
    got = tq.encode_int8_torch(torch.from_numpy(codes), torch.from_numpy(factor))
    ref = np.clip(np.rint(codes.astype(np.float32) * factor), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got.numpy(), ref)
