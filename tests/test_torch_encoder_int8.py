"""int8 inference towers of the PyTorch port (haconvdr_torch/models/encoder.py)
against the JAX package (haconvdr_tpu/models/encoder.py): parameter
quantization, the int8 state dict, and the tiny tower end to end with the
same numpy weights.

Tolerances, on the unit-scale LayerNorm output:
* float32 carry (unfused int8 dense in both packages): within 2e-3
  (measured 4.4e-7: the same float32 ops, but a summation-order
  difference can flip one activation code at a .5 boundary, which moves
  an output by up to ~1e-3);
* bfloat16 carry (the port routes through the fused LayerNorm-quant and
  MLP twins; XLA:CPU runs the unfused ops and keeps some bfloat16
  intermediates in float32): within 0.02 (measured 6.0e-3), cosine
  above 0.9999.
Inside the port, the fused route equals the unfused route bit for bit
(the twins are the unfused ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haconvdr_tpu.config import ModelConfig
from haconvdr_tpu.models import encoder as jenc
from haconvdr_torch.models.convert import init_params_numpy, params_from_jax
from haconvdr_torch.models.encoder import AnceEncoder, Int8Linear, quantize_encoder_params
from haconvdr_torch.ops import fused_ln, fused_mlp


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_quant(params):
    return _np_tree(jenc.quantize_encoder_params(jax.tree_util.tree_map(jnp.asarray, params)))


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("layout", ["list", "stacked"])
def test_quantize_encoder_params_matches_jax_bit_for_bit(layout):
    cfg = ModelConfig.tiny(hidden_size=64, intermediate_size=128)
    params = init_params_numpy(cfg, seed=2)
    if layout == "stacked":
        params = _np_tree(jenc.stack_layer_params(params))
    ours = quantize_encoder_params(params)
    _assert_trees_equal(ours, _jax_quant(params))
    dense = ours["layers"]["intermediate"] if layout == "stacked" else ours["layers"][0]["intermediate"]
    assert dense["kernel"].dtype == np.int8 and dense["kernel_scale"].dtype == np.float32
    assert ours["embedding_head"]["kernel"].dtype == np.float32  # stays float


def test_quantize_encoder_params_is_idempotent():
    """Quantizing twice equals quantizing once in the port.  The reference
    quantizes the int8 codes again (haconvdr_tpu/serve.py:104 on int8
    params): every scale becomes max|code| / 127 = 1, the codes' own range,
    no longer the weights'."""
    cfg = ModelConfig.tiny()
    once = quantize_encoder_params(init_params_numpy(cfg, seed=5))
    _assert_trees_equal(quantize_encoder_params(once), once)
    twice_jax = _jax_quant(once)
    s_once = once["layers"][0]["attention"]["query"]["kernel_scale"]
    s_twice = twice_jax["layers"][0]["attention"]["query"]["kernel_scale"]
    assert not np.allclose(s_twice, s_once)
    np.testing.assert_array_equal(s_twice, np.ones_like(s_once))


@pytest.mark.parametrize("layout", ["list", "stacked"])
def test_params_from_jax_carries_int8_kernels(layout):
    cfg = ModelConfig.tiny()
    q = quantize_encoder_params(init_params_numpy(cfg, seed=0))
    src = _np_tree(jenc.stack_layer_params(q)) if layout == "stacked" else q
    sd = params_from_jax(src)
    H = cfg.hidden_size
    a = q["layers"][1]["attention"]
    qkv = sd["layers.1.attention.qkv.weight"]
    assert qkv.dtype == torch.int8 and tuple(qkv.shape) == (3 * H, H)
    np.testing.assert_array_equal(qkv.numpy()[H : 2 * H], a["key"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["layers.1.attention.qkv.kernel_scale"].numpy(),
        np.concatenate([a[n]["kernel_scale"] for n in ("query", "key", "value")]),
    )
    np.testing.assert_array_equal(
        sd["layers.1.output.weight"].numpy(), q["layers"][1]["output"]["kernel"].T
    )
    assert sd["embedding_head.weight"].dtype == torch.float32
    enc = AnceEncoder.from_jax_params(src, cfg, "cpu")
    assert enc.int8 and isinstance(enc.layers[0].intermediate, Int8Linear)
    assert set(sd) == set(enc.state_dict())


def _inputs(cfg, B=3, L=24, lengths=(24, 9, 2)):
    r = np.random.RandomState(5)
    ids = r.randint(3, cfg.vocab_size, (B, L)).astype(np.int32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
    ids[mask == 0] = 0
    return ids, mask


def _encode(enc, ids, mask, use_mean=False):
    with torch.inference_mode():
        return enc(torch.from_numpy(ids), torch.from_numpy(mask), use_mean=use_mean).numpy()


@pytest.mark.parametrize("use_mean", [False, True], ids=["cls", "mean"])
@pytest.mark.parametrize("dtype, atol", [("float32", 2e-3), ("bfloat16", 0.02)])
def test_int8_tower_matches_jax(dtype, atol, use_mean):
    cfg = ModelConfig.tiny(dtype=dtype)
    params = init_params_numpy(cfg, seed=4)
    ids, mask = _inputs(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_quant(params))
    ref = np.asarray(
        jenc.encode(jp, cfg, jnp.asarray(ids), jnp.asarray(mask), use_mean=use_mean)
    )
    out = _encode(AnceEncoder.from_jax_params(quantize_encoder_params(params), cfg, "cpu"),
                  ids, mask, use_mean)
    assert out.shape == (3, cfg.embedding_dim) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)
    cos = (out * ref).sum(1) / np.linalg.norm(out, axis=1) / np.linalg.norm(ref, axis=1)
    assert cos.min() > 0.9999


def _counts_of_forward(cfg, params, ids, mask):
    for mod in (fused_ln, fused_mlp):
        for k in mod.COUNTS:
            mod.COUNTS[k] = 0
    out = _encode(AnceEncoder.from_jax_params(params, cfg, "cpu"), ids, mask)
    return out, dict(fused_ln.COUNTS), dict(fused_mlp.COUNTS)


def test_int8_tower_routes_as_the_reference_gates():
    """bf16 carry: the embeddings LN and each attention residual LN go
    through the LN-quant twin (1 + L calls), each MLP block through the
    MLP twin (L); use_fused_mlp=False moves the MLP's LN back to LN-quant
    (1 + 2 L); a float32 carry or float kernels take no fused route.  The
    fused route equals the unfused one (use_fused_ln=False) bit for bit."""
    L = 2
    base = ModelConfig.tiny(dtype="bfloat16", num_hidden_layers=L)
    params = quantize_encoder_params(init_params_numpy(base, seed=6))
    ids, mask = _inputs(base)
    fused, ln_c, mlp_c = _counts_of_forward(base, params, ids, mask)
    assert ln_c["plain"] == 1 + L and mlp_c["plain"] == L
    assert ln_c["ln_quant"] == ln_c["ln"] == mlp_c["kernel"] == 0
    no_mlp, ln_c, mlp_c = _counts_of_forward(
        ModelConfig.tiny(dtype="bfloat16", num_hidden_layers=L, use_fused_mlp=False),
        params, ids, mask,
    )
    assert ln_c["plain"] == 1 + 2 * L and mlp_c["plain"] == 0
    unfused, ln_c, mlp_c = _counts_of_forward(
        ModelConfig.tiny(dtype="bfloat16", num_hidden_layers=L, use_fused_ln=False),
        params, ids, mask,
    )
    assert ln_c["plain"] == mlp_c["plain"] == 0
    np.testing.assert_array_equal(fused, unfused)
    np.testing.assert_array_equal(no_mlp, unfused)
    for cfg, p in (
        (ModelConfig.tiny(dtype="float32", num_hidden_layers=L), params),
        (base, init_params_numpy(base, seed=6)),
    ):
        _, ln_c, mlp_c = _counts_of_forward(cfg, p, ids, mask)
        assert ln_c["plain"] == mlp_c["plain"] == 0
