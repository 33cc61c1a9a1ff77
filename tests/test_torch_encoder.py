"""ANCE query tower of the PyTorch port (haconvdr_torch/models) against the
JAX reference encoder (haconvdr_tpu/models/encoder.py:encode) with the
same numpy weights.  float32 within atol 1e-5; bfloat16 (tanh GELU, bf16
carry) within 3e-3 absolute on the unit-scale LayerNorm output (measured
2.4e-3; XLA:CPU keeps some bfloat16 intermediates in float32).  One bf16
dense equals JAX's within 1e-5 of its largest output: both accumulate the
exact products of the bf16-rounded operands in float32 and round once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.config import ModelConfig
from haconvdr_tpu.models import encoder as jenc
from haconvdr_torch.models.convert import init_params_numpy, params_from_jax
from haconvdr_torch.models import encoder as tenc
from haconvdr_torch.models.encoder import AnceEncoder, roberta_position_ids


def _inputs(rng, cfg, B=3, L=24, lengths=(24, 9, 2)):
    ids = rng.randint(3, cfg.vocab_size, (B, L)).astype(np.int32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
    ids[mask == 0] = 0  # ConcatBuilder pads with token 0
    return ids, mask


def _jax_encode(params, cfg, ids, mask, use_mean=False):
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(
        jenc.encode(jp, cfg, jnp.asarray(ids), jnp.asarray(mask), use_mean=use_mean)
    )


@pytest.mark.parametrize("use_mean", [False, True], ids=["cls", "mean"])
def test_encode_matches_jax_f32(rng, use_mean):
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=3)
    ids, mask = _inputs(rng, cfg)
    ref = _jax_encode(params, cfg, ids, mask, use_mean)
    enc = AnceEncoder.from_jax_params(params, cfg)
    with torch.inference_mode():
        out = enc(torch.from_numpy(ids), torch.from_numpy(mask), use_mean=use_mean)
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, cfg.embedding_dim)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_encode_matches_jax_bf16(rng):
    cfg = ModelConfig.tiny(dtype="bfloat16")
    params = init_params_numpy(cfg, seed=4)
    ids, mask = _inputs(rng, cfg)
    ref = _jax_encode(params, cfg, ids, mask)
    enc = AnceEncoder.from_jax_params(params, cfg)
    with torch.inference_mode():
        out = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-3, rtol=0)


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16], ids=["f32_out", "bf16_out"])
def test_dense_bf16_matches_jax(out_dtype):
    """float32 accumulation of the bf16-rounded operands, the bias added in
    float32, one rounding to out_dtype (haconvdr_tpu/models/encoder.py:141-145)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 256), dtype=np.float32) * 2.0
    k = rng.standard_normal((256, 128), dtype=np.float32) * 0.1
    b = rng.standard_normal(128, dtype=np.float32)
    jdt = None if out_dtype is None else jnp.bfloat16
    ref = np.asarray(
        jenc._dense(jnp.asarray(x), {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)},
                    jnp.bfloat16, out_dtype=jdt),
        np.float32,
    )
    lin = torch.nn.Linear(256, 128)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(k.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
        out = tenc._dense(torch.from_numpy(x), lin, torch.bfloat16, out_dtype=out_dtype)
    assert out.dtype == (out_dtype or torch.float32)
    bound = 1e-5 * np.abs(ref).max()
    if out_dtype is not None:  # plus half a bf16 ulp where a rounding flips
        bound += 2.0**-9 * np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).max() <= bound


def test_params_from_jax_layout():
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=0)
    sd = params_from_jax(params)
    H = cfg.hidden_size
    a = params["layers"][1]["attention"]
    qkv = sd["layers.1.attention.qkv.weight"].numpy()
    assert qkv.shape == (3 * H, H)
    np.testing.assert_array_equal(qkv[:H], a["query"]["kernel"].T)
    np.testing.assert_array_equal(qkv[2 * H :], a["value"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["layers.1.intermediate.weight"].numpy(), params["layers"][1]["intermediate"]["kernel"].T
    )
    # every module parameter is covered, nothing extra
    enc = AnceEncoder(cfg)
    assert set(sd) == set(enc.state_dict())
    for name, t in enc.state_dict().items():
        assert tuple(sd[name].shape) == tuple(t.shape), name
    # the stacked JAX layout converts to the same state dict
    stacked = jax.tree_util.tree_map(np.asarray, jenc.stack_layer_params(params))
    sd2 = params_from_jax(stacked)
    for name in sd:
        np.testing.assert_array_equal(sd[name].numpy(), sd2[name].numpy())


def test_init_params_numpy_matches_jax_tree():
    cfg = ModelConfig.tiny()
    ours = init_params_numpy(cfg, seed=0)
    theirs = jenc.init_encoder_params(jax.random.PRNGKey(0), cfg)
    a = jax.tree_util.tree_structure(ours)
    b = jax.tree_util.tree_structure(theirs)
    assert a == b
    for x, y in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert x.shape == y.shape and x.dtype == np.float32
    w = ours["embeddings"]["word_embeddings"]
    assert abs(float(w.std()) - 0.02) < 0.002
    np.testing.assert_array_equal(init_params_numpy(cfg, 0)["norm"]["scale"], 1.0)


def test_roberta_position_ids_match_jax(rng):
    ids = rng.randint(0, 6, (4, 16)).astype(np.int32)
    ref = np.asarray(jenc.roberta_position_ids(jnp.asarray(ids), 1))
    out = roberta_position_ids(torch.from_numpy(ids), 1)
    np.testing.assert_array_equal(out.numpy(), ref)
