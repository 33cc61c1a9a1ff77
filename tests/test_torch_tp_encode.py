"""The tensor-parallel encode of the PyTorch port
(haconvdr_torch/parallel/sharded_encode.py: encoder_param_pspecs,
shard_params(tp=True), dp_encode_fn on a dp x tp mesh; models/convert.py:
tp_slice; models/encoder.py: encode_split; ops/fused_mlp.py's split mode)
against the JAX package's make_sharded_encode_fn(tp=True) and against the
port's own un-split towers.

Tolerances:
  * float32 tower split over tp against JAX's on the same mesh shape:
    1e-4 (tests/test_parallel.py:56-70's bound; the row-split denses sum
    float32 partials over the ranks, a rounding the un-split tower does
    not make);
  * int8 towers (bf16 carry, fused route through the plain twins) under tp
    2 and 4 against the port's un-split int8 tower: bit for bit (every
    code and every int32 sum is the un-split tower's); against JAX's
    un-split int8 tower: tests/test_torch_encoder_int8.py's bound (0.02,
    cosine > 0.9999);
  * get_test_query_embeddings with replicated params on dp 2 x tp 4
    against JAX's: 1e-5 (tests/test_torch_parallel.py's dp bound), ids
    equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from haconvdr_tpu import retrieval as jretrieval
from haconvdr_tpu.config import ExperimentConfig as JExperimentConfig
from haconvdr_tpu.config import ModelConfig as JModelConfig
from haconvdr_tpu.models import encoder as jenc
from haconvdr_tpu.parallel import sharded_encode as jse
from haconvdr_tpu.parallel.mesh import make_mesh as jax_mesh
from haconvdr_torch import retrieval as tretrieval
from haconvdr_torch.config import ExperimentConfig, ModelConfig
from haconvdr_torch.models.convert import init_params_numpy, params_to_jax, tp_slice
from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params
from haconvdr_torch.ops import fused_attention, fused_mlp
from haconvdr_torch.parallel.mesh import make_mesh
from haconvdr_torch.parallel.sharded_encode import (
    dp_encode_fn,
    encoder_param_pspecs,
    shard_params,
)


def cpu_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _ids(cfg, B, L, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, cfg.vocab_size, size=(B, L)).astype(np.int32)
    lens = rng.randint(2, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _zero_counts():
    for mod in (fused_attention, fused_mlp):
        for k in mod.COUNTS:
            mod.COUNTS[k] = 0


def _split_encode(mesh, params, cfg, ids, mask):
    with torch.inference_mode():
        fn = dp_encode_fn(mesh, shard_params(mesh, params, tp=True, cfg=cfg))
        return fn(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


def test_tp_encode_matches_jax_on_dp2_tp4():
    """tests/test_parallel.py:56-70's case: dp 2 x tp 4, B 4, L 8."""
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=1)
    ids, mask = _ids(cfg, 4, 8, seed=0)
    mask[:] = 1
    jmesh = jax_mesh(dp=2, tp=4)
    fn = jse.make_sharded_encode_fn(jmesh, JModelConfig(**dataclasses.asdict(cfg)), tp=True)
    ref = np.asarray(fn(jse.shard_params(jmesh, params, tp=True), jnp.asarray(ids),
                        jnp.asarray(mask)))
    _zero_counts()
    out = _split_encode(cpu_mesh(2, 4), params, cfg, ids, mask)
    # each dp row ran its group: every rank's attention on one head
    assert fused_attention.COUNTS == {"kernel": 0, "plain": 2 * 4 * cfg.num_hidden_layers}
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dp, tp", [(1, 4), (4, 2), (2, 4)])
def test_float_split_tower_agrees_with_the_unsplit_one(dp, tp):
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=2)
    ids, mask = _ids(cfg, 6, 9, seed=1)
    with torch.inference_mode():
        ref = AnceEncoder.from_jax_params(params, cfg, "cpu")(
            torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(_split_encode(cpu_mesh(dp, tp), params, cfg, ids, mask), ref,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("tp", [2, 4])
def test_int8_split_tower_equals_the_unsplit_tower_bit_for_bit(tp, use_fused):
    """bf16 carry: LayerNorm-quant and the MLP block's split mode (fused),
    or the unfused int8 denses; the attention-output dense's codes take the
    group's row maximum and its int32 partials meet before the
    dequantization."""
    cfg = ModelConfig.tiny(dtype="bfloat16", use_fused_mlp=use_fused, use_fused_ln=use_fused)
    params = quantize_encoder_params(init_params_numpy(cfg, seed=3))
    ids, mask = _ids(cfg, 5, 12, seed=2)
    with torch.inference_mode():
        ref = AnceEncoder.from_jax_params(params, cfg, "cpu")(
            torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    _zero_counts()
    out = _split_encode(cpu_mesh(1, tp), params, cfg, ids, mask)
    n = cfg.num_hidden_layers if use_fused else 0
    assert fused_mlp.COUNTS == {"kernel": 0, "plain": 0, "split_up": 0, "split_down": 0,
                                "split_finish": 0, "plain_split_up": tp * n,
                                "plain_split_down": tp * n, "plain_split_finish": n}
    np.testing.assert_array_equal(out, ref)
    # and JAX's un-split int8 tower
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jp = jax.tree_util.tree_map(jnp.asarray, jenc.quantize_encoder_params(
        jax.tree_util.tree_map(jnp.asarray, init_params_numpy(cfg, seed=3))))
    jref = np.asarray(jenc.encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(out, jref, atol=0.02, rtol=0)
    cos = (out * jref).sum(1) / np.linalg.norm(out, axis=1) / np.linalg.norm(jref, axis=1)
    assert cos.min() > 0.9999


def _kind(spec) -> str:
    """JAX's PartitionSpec as the port names it."""
    axes = tuple(spec)
    if "tp" not in axes:
        return "replicated"
    return "column" if axes[-1] == "tp" else "row"


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("stacked", [False, True], ids=["list", "stacked"])
def test_pspecs_name_jaxs_split_for_every_leaf(stacked, quantized):
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=4)
    if stacked:
        params = params_to_jax(AnceEncoder.from_jax_params(params, cfg, "cpu").state_dict(),
                               stacked=True)
    if quantized:
        params = quantize_encoder_params(params)
    ref = jse.encoder_param_pspecs(params)
    ours = encoder_param_pspecs(params)
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref, is_leaf=is_p)
    want = [_kind(s) for s in jax.tree_util.tree_leaves(ref, is_leaf=is_p)]
    assert jax.tree_util.tree_leaves(ours) == want
    assert {"column", "row", "replicated"} == set(want)
    # tp_slice cuts each leaf along the axis JAX's spec shards
    for rank in range(4):
        sl = tp_slice(params, rank, 4)
        for a, s, spec in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(sl),
                              jax.tree_util.tree_leaves(ref, is_leaf=is_p)):
            axes = tuple(spec)
            if "tp" not in axes:
                np.testing.assert_array_equal(s, a)
                continue
            ax = axes.index("tp")
            n = np.shape(a)[ax] // 4
            np.testing.assert_array_equal(
                s, np.take(np.asarray(a), np.arange(rank * n, (rank + 1) * n), axis=ax))


def test_tp_must_divide_heads_and_intermediate():
    cfg = ModelConfig.tiny()  # 4 heads, intermediate 64
    params = init_params_numpy(cfg, seed=5)
    for tp in (3, 8):
        with pytest.raises(ValueError, match="must divide num_attention_heads"):
            shard_params(make_mesh(dp=1, tp=tp, devices=["cpu"] * tp), params, tp=True, cfg=cfg)
    with pytest.raises(ValueError, match="must divide"):
        AnceEncoder(ModelConfig.tiny(intermediate_size=66), tp=4)


def test_get_test_query_embeddings_on_dp2_tp4_matches_jax():
    """Replicated params on dp 2 x tp 4 in both packages: batches of
    per_device_test_batch_size x 8, each cut over the two dp rows."""
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=6)
    rng = np.random.RandomState(7)
    examples = []
    for i in range(37):  # padded to 10 tokens, as the loaders pad
        n = int(rng.randint(2, 11))
        toks = rng.randint(4, cfg.vocab_size, n).tolist()
        examples.append({"sample_id": f"q{i}", "conv_qp": toks + [0] * (10 - n),
                         "conv_qp_mask": [1] * n + [0] * (10 - n)})
    exp = ExperimentConfig(model=cfg)
    exp.search.per_device_test_batch_size = 2
    jexp = JExperimentConfig(model=JModelConfig(**dataclasses.asdict(cfg)))
    jexp.search.per_device_test_batch_size = 2
    ref, ref_ids = jretrieval.get_test_query_embeddings(
        jexp, jax.tree_util.tree_map(jnp.asarray, params), mesh=jax_mesh(dp=2, tp=4),
        examples=examples)
    enc = AnceEncoder.from_jax_params(params, cfg, "cpu")
    calls = []
    orig = enc.forward
    enc.forward = lambda x, m, **kw: calls.append(x.shape[0]) or orig(x, m, **kw)
    got, ids = tretrieval.get_test_query_embeddings(exp, enc, examples=examples,
                                                    mesh=cpu_mesh(2, 4))
    assert ids == ref_ids == [e["sample_id"] for e in examples]
    # batches of 16 (the last padded): two dp slices of 8 each, one tp slot
    # running a slice; the last batch's second slice holds padding only
    assert calls == [8, 8, 8, 8, 8]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_retriever_on_a_dp_tp_mesh_answers_as_on_dp_only(tmp_path):
    """Retriever(mesh=dp 2 x tp 4): the tower replicated (one tp slot a dp
    row runs), the flat index sharded over all eight slots; the same pids
    as on eight dp slots, scores within 1e-5 (the embed batch is cut into
    other slice shapes)."""
    from haconvdr_torch.config import DataConfig, SearchConfig
    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.serve import Retriever
    from haconvdr_torch.utils.testing import HashTokenizer

    cfg = ModelConfig.tiny(vocab_size=512)
    params = init_params_numpy(cfg, seed=12)
    r = np.random.RandomState(6)
    store = EmbeddingBlockStore(str(tmp_path / "emb"))
    store.write_block(0, r.randn(100, cfg.embedding_dim).astype(np.float32), np.arange(100))
    data_cfg = DataConfig(is_train=False, use_PRL=False, max_query_length=12,
                          max_doc_length=16, max_response_length=8, max_concat_length=32)
    kw = dict(data_cfg=data_cfg, search_cfg=SearchConfig(top_k=8, per_device_test_batch_size=2))
    tok = HashTokenizer(cfg.vocab_size)
    tp = Retriever(tok, params, cfg, store, mesh=cpu_mesh(2, 4), **kw)
    dp = Retriever(tok, params, cfg, store, mesh=cpu_mesh(8, 1), **kw)
    assert len(tp.index.shards) == 8
    for qn, h in (("what is the capital of france", [("who wrote hamlet", "shakespeare")]),
                  ("tell me about rivers", [])):
        ours, ref = tp.retrieve(qn, h), dp.retrieve(qn, h)
        assert [p for p, _ in ours] == [p for p, _ in ref]
        np.testing.assert_allclose([s for _, s in ours], [s for _, s in ref], rtol=1e-5,
                                   atol=1e-5)
