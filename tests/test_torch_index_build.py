"""Corpus encoding of the PyTorch port (haconvdr_torch/index/build.py,
models/hf_import.py, cli/gen_doc_embeddings.py) against the JAX package's
on a fabricated tokenized corpus and a tiny checkpoint written by the JAX
``save_hf_checkpoint`` (no transformers tokenizer).

Pass conditions: the same blocks (count, ids, passage offsets in each,
dtype).  Rows: a float32 tower within 1e-5 (as test_torch_encoder.py);
int8 towers within the tower tolerances of test_torch_encoder_int8.py,
2e-3 with a float32 carry and 0.02 with a bfloat16 carry.  int8 blocks
hold exactly ``quantize_int8`` of the port's own float rows, and
bfloat16 blocks their bfloat16 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from haconvdr_tpu.config import ModelConfig
from haconvdr_tpu.index.build import encode_corpus as jax_encode_corpus
from haconvdr_tpu.index.quantize import quantize_int8
from haconvdr_tpu.index.store import EmbeddingBlockStore, TokenizedCorpus, TokenizedCorpusWriter
from haconvdr_tpu.models import encoder as jenc
from haconvdr_tpu.models import hf_import as jhf
from haconvdr_torch.index.build import encode_corpus
from haconvdr_torch.models import hf_import as thf
from haconvdr_torch.models.convert import init_params_numpy
from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params

N_PASSAGES, MAX_LEN = 40, 16


def _write_corpus(path, n=N_PASSAGES, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    w = TokenizedCorpusWriter(str(path), max_seq_length=MAX_LEN)
    for i in range(n):
        w.add(500 + 7 * i, rng.integers(3, vocab, int(rng.integers(2, MAX_LEN + 1))).tolist())
    w.finalize()
    return TokenizedCorpus(str(path))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("corpus") / "c")


def _blocks(store):
    return [store.read_block(b) for b in range(store.num_blocks())]


def _block_ids(store):
    """The ids of the blocks present (a run may start past block 0)."""
    return [b for b in range(16) if store.has_block(b)]


def _assert_same_layout(ours, ref):
    assert len(ours) == len(ref)
    for (e, i), (re, ri) in zip(ours, ref):
        np.testing.assert_array_equal(i, ri)
        assert e.shape == re.shape and e.dtype == re.dtype


def _assert_rows_close(ours, ref, atol):
    _assert_same_layout(ours, ref)
    for (e, _), (re, _) in zip(ours, ref):
        np.testing.assert_allclose(e, re, atol=atol, rtol=0)


TOWERS = [  # (carry dtype, int8 kernels, tolerance)
    ("float32", False, 1e-5),
    ("float32", True, 2e-3),
    ("bfloat16", True, 0.02),  # the fused LayerNorm-quant and MLP route
]


@pytest.mark.parametrize("dtype, int8, atol", TOWERS, ids=["f32", "int8_f32", "int8_bf16"])
def test_encode_corpus_matches_jax(corpus, tmp_path, dtype, int8, atol):
    cfg = ModelConfig.tiny(dtype=dtype)
    params = init_params_numpy(cfg, seed=3)
    if int8:
        params = quantize_encoder_params(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    fn = jax.jit(lambda p, ids, mask: jenc.encode(p, cfg, ids, mask))
    kw = dict(batch_size=16, per_block_passage_num=32)  # blocks of 32 + 8 rows
    ref = _blocks(jax_encode_corpus(corpus, fn, jp, str(tmp_path / "jax"), **kw))
    enc = AnceEncoder.from_jax_params(params, cfg, "cpu")
    assert enc.int8 == int8
    ours = _blocks(encode_corpus(corpus, enc, str(tmp_path / "f32"), **kw))
    assert [len(i) for _, i in ours] == [32, 8]
    np.testing.assert_array_equal(np.concatenate([i for _, i in ours]), np.arange(N_PASSAGES))
    _assert_rows_close(ours, ref, atol)
    q8 = _blocks(encode_corpus(corpus, enc, str(tmp_path / "i8"), store_dtype="int8", **kw))
    store8 = EmbeddingBlockStore(str(tmp_path / "i8"))
    for b, ((codes, ids), (rows, rids)) in enumerate(zip(q8, ours)):
        want_codes, want_scale = quantize_int8(rows)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(codes, want_codes)
        np.testing.assert_array_equal(store8.block_scale(b), want_scale)
    bf = _blocks(encode_corpus(corpus, enc, str(tmp_path / "bf"), store_dtype="bfloat16", **kw))
    for (e, _), (rows, _) in zip(bf, ours):
        assert e.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(e, rows.astype(ml_dtypes.bfloat16))


def test_encode_corpus_multi_chunk_output_matches_jax(tmp_path):
    """An encoder emitting [B, n_chunks, D] stores one row per chunk,
    chunk-major per batch, every chunk carrying its passage's offset
    (haconvdr_tpu/index/build.py:248-260)."""
    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=4)
    for pid in range(6):
        w.add(pid + 100, [1 + pid, 2])
    w.finalize()
    corpus = TokenizedCorpus(str(tmp_path / "c"))
    D, n_chunks = 3, 2

    def value(ids, xp):
        b = ids.shape[0]
        base = xp.arange(b, dtype=xp.float32)[:, None, None] * 10.0
        chunk = xp.arange(n_chunks, dtype=xp.float32)[None, :, None]
        return base + chunk + xp.zeros((b, n_chunks, D)) + ids[:, :1, None].astype(xp.float32) * 100.0

    ref = _blocks(jax_encode_corpus(
        corpus, lambda p, ids, mask: value(ids, jnp), None, str(tmp_path / "jax"),
        batch_size=4, per_block_passage_num=100,
    ))

    def torch_fn(ids, mask):
        return torch.from_numpy(value(ids.numpy(), np).astype(np.float32))

    ours = _blocks(encode_corpus(
        corpus, torch_fn, str(tmp_path / "torch"), batch_size=4, per_block_passage_num=100,
        device="cpu",
    ))
    _assert_rows_close(ours, ref, 0.0)
    np.testing.assert_array_equal(ours[0][1], [0, 1, 2, 3, 0, 1, 2, 3, 4, 5, 4, 5])


def test_encode_corpus_shards_and_numbers_blocks_like_jax(corpus, tmp_path):
    """stride / offset take every stride-th passage from offset, and the
    blocks are numbered from start_block_id."""
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=1)
    fn = jax.jit(lambda p, ids, mask: jenc.encode(p, cfg, ids, mask))
    kw = dict(batch_size=4, per_block_passage_num=9, stride=3, offset=2, start_block_id=4)
    ref_store = jax_encode_corpus(
        corpus, fn, jax.tree_util.tree_map(jnp.asarray, params), str(tmp_path / "jax"), **kw
    )
    store = encode_corpus(corpus, AnceEncoder.from_jax_params(params, cfg, "cpu"), str(tmp_path / "t"), **kw)
    assert _block_ids(store) == _block_ids(ref_store) == [4, 5]
    ours = [store.read_block(b) for b in _block_ids(store)]
    _assert_rows_close(ours, [ref_store.read_block(b) for b in _block_ids(ref_store)], 1e-5)
    np.testing.assert_array_equal(np.concatenate([i for _, i in ours]), np.arange(2, N_PASSAGES, 3))


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("model_type", ["ANCE", "BERT"])
def test_hf_checkpoint_roundtrip_across_packages(tmp_path, model_type):
    cfg = ModelConfig.tiny(model_type=model_type)
    params = init_params_numpy(cfg, seed=8)
    jhf.save_hf_checkpoint(params, cfg, str(tmp_path / "jax"))
    thf.save_hf_checkpoint(params, cfg, str(tmp_path / "torch"))
    for src in ("jax", "torch"):
        ours, ours_cfg = thf.load_hf_checkpoint(str(tmp_path / src), model_type)
        ref, ref_cfg = jhf.load_hf_checkpoint(str(tmp_path / src), model_type)
        assert dataclasses.asdict(ours_cfg) == dataclasses.asdict(ref_cfg)
        _assert_trees_equal(ours, ref)
        _assert_trees_equal(ours, params)
    sd = thf.state_dict_from_params(params, cfg)
    ref_sd = jhf.state_dict_from_params(params, cfg)
    assert sd.keys() == ref_sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref_sd[k])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = ModelConfig.tiny()
    out = tmp_path_factory.mktemp("ckpt")
    jhf.save_hf_checkpoint(init_params_numpy(cfg, seed=12), cfg, str(out))
    return str(out)


@pytest.mark.parametrize(
    "int8, shard",
    [(False, []), (True, ["shard_stride=2", "shard_offset=1", "start_block_id=3"])],
    ids=["float", "int8_sharded"],
)
def test_cli_matches_the_jax_cli(corpus, checkpoint, tmp_path, int8, shard):
    """Both CLIs on the same checkpoint and corpus.  The JAX CLI's batch is
    per_device_eval_batch_size times its 8 CPU devices, the port's is one
    device's; blocks of 32 passages are whole batches in both.  The
    checkpoint's config gives both int8 towers a float32 carry."""
    from haconvdr_tpu.cli.gen_doc_embeddings import main as jax_main
    from haconvdr_torch.cli.gen_doc_embeddings import main as torch_main

    args = [
        f"model.pretrained_encoder_path={checkpoint}",
        f"index.tokenized_dir={corpus.dir_path}",
        "index.per_device_eval_batch_size=2",
        "index.per_block_passage_num=32",
        f"index.compute_int8={'true' if int8 else 'false'}",
        *shard,
    ]
    jax_main(args + [f"index.data_output_path={tmp_path / 'jax'}"])
    store = torch_main(args + [f"index.data_output_path={tmp_path / 'torch'}", "--device", "cpu"])
    ref_store = EmbeddingBlockStore(str(tmp_path / "jax"))
    assert _block_ids(store) == _block_ids(ref_store)
    assert _block_ids(store)[0] == (3 if shard else 0)
    ours = [store.read_block(b) for b in _block_ids(store)]
    _assert_rows_close(ours, [ref_store.read_block(b) for b in _block_ids(ref_store)],
                       2e-3 if int8 else 1e-5)
    ids = np.concatenate([i for _, i in ours])
    np.testing.assert_array_equal(ids, np.arange(1 if shard else 0, N_PASSAGES, 2 if shard else 1))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stores_read_across_packages(tmp_path, writer):
    """The port keeps its own copy of index/store.py: a store or tokenized
    corpus written by either package reads the same in the other (npy
    blocks in f32, int8 with scales and bf16, reference pickle blocks,
    the offset/pid pickles)."""
    from haconvdr_tpu.index import store as jstore
    from haconvdr_torch.index import store as tstore

    w_mod, r_mod = (jstore, tstore) if writer == "jax" else (tstore, jstore)
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((20, 8)).astype(np.float32)
    ids = np.arange(20, dtype=np.int64) * 3 + 1
    codes, scale = quantize_int8(emb)
    out = w_mod.EmbeddingBlockStore(str(tmp_path / "npy"))
    out.write_block(0, emb, ids)
    out.write_block(1, codes, ids, scale=scale)
    out.write_block(2, emb.astype(ml_dtypes.bfloat16), ids)
    w_mod.EmbeddingBlockStore(str(tmp_path / "pb"), fmt="pickle").write_block(0, emb, ids)
    back = r_mod.EmbeddingBlockStore(str(tmp_path / "npy"))
    assert back.num_blocks() == 3
    for b, want in enumerate([emb, codes, emb.astype(ml_dtypes.bfloat16)]):
        e, i = back.read_block(b)
        assert e.dtype == want.dtype
        np.testing.assert_array_equal(e, want)
        np.testing.assert_array_equal(i, ids)
    np.testing.assert_array_equal(back.block_scale(1), scale)
    np.testing.assert_array_equal(list(back.iter_blocks())[1][0], codes.astype(np.float32) * scale)
    e, i = r_mod.EmbeddingBlockStore.open_auto(str(tmp_path / "pb")).read_block(0)
    np.testing.assert_array_equal(e, emb)
    w = w_mod.TokenizedCorpusWriter(str(tmp_path / "tok"), max_seq_length=6)
    for pid in range(7):
        w.add(900 + pid, list(range(1, 2 + pid)))
    w.finalize()
    corpus, ref = r_mod.TokenizedCorpus(str(tmp_path / "tok")), w_mod.TokenizedCorpus(str(tmp_path / "tok"))
    assert len(corpus) == 7 and corpus.offset2pid() == ref.offset2pid()
    for got, want in zip(corpus.batches(3), ref.batches(3)):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


def test_cli_refuses_to_run_without_the_card(corpus, checkpoint, tmp_path, monkeypatch):
    """No fallback: without a card the CLI raises before it reads
    anything, unless it is given --device cpu."""
    from haconvdr_torch.cli.gen_doc_embeddings import main as torch_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [
        f"model.pretrained_encoder_path={checkpoint}",
        f"index.tokenized_dir={corpus.dir_path}",
        f"index.data_output_path={tmp_path / 'out'}",
    ]
    with pytest.raises(RuntimeError, match="is_available"):
        torch_main(args)
    with pytest.raises(RuntimeError, match="is_available"):
        torch_main(args + ["--device=cuda"])
    assert not (tmp_path / "out").exists()
    store = torch_main(args + ["--device=cpu"])
    assert store.num_blocks() == 1
