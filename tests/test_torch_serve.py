"""The whole serving slice of the PyTorch port (haconvdr_torch/serve.py)
against the JAX reference (haconvdr_tpu/serve.py): one shared-writer
EmbeddingBlockStore, one tokenizer, the same numpy encoder weights.
Pass conditions: identical ranked pids for conversational queries with
scores within 1e-5; BatchingRetriever answers equal the sequential path;
the two-stage rescore path agrees with JAX.  int8 residency, super-block
streaming and bfloat16 streaming are held against JAX the same way (the
int8 scoring-model difference is stated in its test)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from haconvdr_tpu.config import DataConfig, ModelConfig, SearchConfig
from haconvdr_tpu.index.quantize import quantize_int8
from haconvdr_tpu.index.store import EmbeddingBlockStore
from haconvdr_tpu.serve import Retriever as JaxRetriever
from haconvdr_torch.index.quantize import quantize_queries_int8
from haconvdr_torch.models.convert import init_params_numpy
from haconvdr_torch.serve import BacklogFull, BatchingRetriever, Retriever
from haconvdr_torch.utils.testing import HashTokenizer

N_PASSAGES = 90
QUERIES = [
    ("what is the capital of france", [("who wrote hamlet", "shakespeare")]),
    ("and its population", [("capital of france", "paris"), ("is it big", "yes very")]),
    ("tell me about rivers", []),
    ("which one is longest", [("tell me about rivers", "the nile and amazon")]),
]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.RandomState(7)
    cfg = ModelConfig.tiny(vocab_size=512)
    params = init_params_numpy(cfg, seed=11)
    store = EmbeddingBlockStore(str(tmp_path_factory.mktemp("torch_serve") / "emb"))
    base = 0
    for b, n in enumerate([40, 30, 20]):  # three blocks, contiguous ids
        emb = rng.randn(n, cfg.embedding_dim).astype(np.float32)
        store.write_block(b, emb, np.arange(base, base + n, dtype=np.int64))
        base += n
    offset2pid = [1000 + 3 * i for i in range(N_PASSAGES)]
    data_cfg = DataConfig(
        is_train=False, use_PRL=False,
        max_query_length=12, max_doc_length=16, max_response_length=8,
        max_concat_length=32,
    )
    store8 = EmbeddingBlockStore(str(tmp_path_factory.mktemp("torch_serve8") / "emb"))
    for b in range(store.num_blocks()):  # the same rows as int8 blocks
        emb, ids = store.read_block(b)
        codes, scale = quantize_int8(emb)
        store8.write_block(b, codes, ids, scale=scale)
    return dict(
        tok=HashTokenizer(cfg.vocab_size), cfg=cfg, params=params, store=store,
        store8=store8, offset2pid=offset2pid, data_cfg=data_cfg,
    )


def _pair(setup, store="store", retriever_kw=None, **search_kw):
    kw = dict(
        offset2pid=setup["offset2pid"], data_cfg=setup["data_cfg"],
        search_cfg=SearchConfig(top_k=8, per_device_test_batch_size=2, **search_kw),
        **(retriever_kw or {}),
    )
    jr = JaxRetriever(setup["tok"], setup["params"], setup["cfg"], setup[store], **kw)
    tr = Retriever(setup["tok"], setup["params"], setup["cfg"], setup[store], **kw, device="cpu")
    return jr, tr


def _assert_same(ours, ref):
    assert [p for p, _ in ours] == [p for p, _ in ref]
    np.testing.assert_allclose(
        [s for _, s in ours], [s for _, s in ref], rtol=1e-5, atol=1e-5
    )


def test_retrieve_matches_jax(setup):
    jr, tr = _pair(setup)
    for question, history in QUERIES:
        assert tr.build_query(question, history) == jr.build_query(question, history)
        ours = tr.retrieve(question, history)
        assert len(ours) == 8 and all(p in setup["offset2pid"] for p, _ in ours)
        _assert_same(ours, jr.retrieve(question, history))


def test_streaming_retriever_matches_jax(setup):
    jr, _ = _pair(setup)
    tr = Retriever(
        setup["tok"], setup["params"], setup["cfg"], setup["store"],
        offset2pid=setup["offset2pid"], data_cfg=setup["data_cfg"],
        search_cfg=SearchConfig(top_k=8), resident=False, device="cpu",
    )
    for question, history in QUERIES:
        _assert_same(tr.retrieve(question, history), jr.retrieve(question, history))


def test_streaming_bf16_store_dtype_scores_in_float32(setup):
    """resident=False streams the store in float32 whatever store_dtype
    says, as the JAX Retriever does (haconvdr_tpu/serve.py:220-226)."""
    jr, tr = _pair(setup, retriever_kw=dict(resident=False, store_dtype="bfloat16"))
    assert tr.searcher.compute_dtype == torch.float32
    for question, history in QUERIES:
        _assert_same(tr.retrieve(question, history), jr.retrieve(question, history))


def _int8_oracle(tr, q, k):
    """The int8 x int8 model on the port's own index: scale folded into
    the queries, per-query codes, exact integer scores, ties to the lower
    row, dequantized by q_scale / 127."""
    idx = tr.index
    q8, q_scale = quantize_queries_int8(torch.from_numpy(q) * idx.scale)
    full = q8.numpy().astype(np.int64) @ idx.passages.numpy().astype(np.int64).T
    n = full.shape[1]
    order = np.lexsort((np.tile(np.arange(n), (len(q), 1)), -full), axis=1)[:, :k]
    s = torch.from_numpy(np.take_along_axis(full, order, 1).astype(np.float32))
    return (s * (q_scale[:, None] / 127.0)).numpy(), tr.offset2pid[order]


def test_int8_resident_matches_jax(setup):
    """store_dtype="int8": the index quantizes as the JAX ShardedIndex does
    (codes and scale identical).  For k <= 128 the port scores int8 x int8
    (the JAX package's kernel path, pallas_topk_v4.py:855-861): its answer
    equals that model's oracle exactly.  The JAX CPU path scores the
    bfloat16-rounded folded query instead, so against it the pids are
    identical and the scores agree within the two models' difference
    (query-side rounding, 1/254 of the largest element)."""
    jr, tr = _pair(setup, retriever_kw=dict(store_dtype="int8"))
    np.testing.assert_array_equal(tr.index.passages.numpy(), np.asarray(jr.index.passages)[:N_PASSAGES])
    np.testing.assert_array_equal(tr.index.scale.numpy(), np.asarray(jr.index.scales)[0])
    exs = [tr.build_query(q, h) for q, h in QUERIES]
    q = tr.embed(exs)
    s, i = tr.search(q)
    os_, oi = _int8_oracle(tr, q, 8)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(s, os_)
    for question, history in QUERIES:
        ours, ref = tr.retrieve(question, history), jr.retrieve(question, history)
        assert [p for p, _ in ours] == [p for p, _ in ref]
        np.testing.assert_allclose([x for _, x in ours], [x for _, x in ref], rtol=2e-2, atol=2e-2)


def test_int8_resident_with_rescore_matches_jax(setup):
    """The float disk store rescores the int8 first stage exactly."""
    jr, tr = _pair(setup, retriever_kw=dict(store_dtype="int8"), rescore_oversample=3.0)
    for question, history in QUERIES:
        _assert_same(tr.retrieve(question, history), jr.retrieve(question, history))


def test_int8_over_a_device_tensor_quantizes_on_the_device(setup):
    rng = np.random.RandomState(1)
    emb = rng.randn(50, setup["cfg"].embedding_dim).astype(np.float32)
    tr = Retriever(
        setup["tok"], setup["params"], setup["cfg"], torch.from_numpy(emb),
        data_cfg=setup["data_cfg"], search_cfg=SearchConfig(top_k=5), store_dtype="int8",
        device="cpu",
    )
    codes, scale = quantize_int8(emb)
    np.testing.assert_array_equal(tr.index.passages.numpy(), codes)
    np.testing.assert_array_equal(tr.index.scale.numpy(), scale)


@pytest.mark.parametrize("store, sb_dtype", [("store", ""), ("store8", "int8"), ("store8", "")])
def test_superblock_streaming_matches_jax(setup, store, sb_dtype):
    """resident=False with super-blocks: the store's three blocks fill one
    accumulator (float32, or int8 at the store's global scale)."""
    jr, tr = _pair(
        setup, store=store, retriever_kw=dict(resident=False),
        superblock_rows=131072, superblock_dtype=sb_dtype,
    )
    for question, history in QUERIES:
        _assert_same(tr.retrieve(question, history), jr.retrieve(question, history))


def test_rescore_path_matches_jax(setup):
    jr, tr = _pair(setup, rescore_oversample=3.0)
    for question, history in QUERIES:
        _assert_same(tr.retrieve(question, history), jr.retrieve(question, history))


def test_batching_equals_sequential(setup):
    _, tr = _pair(setup)
    sequential = [tr.retrieve(q, h) for q, h in QUERIES]
    with BatchingRetriever(tr, max_batch=4, max_wait_ms=300.0) as b:
        futs = [b.submit(q, h) for q, h in QUERIES]
        batched = [f.result(timeout=120) for f in futs]
        short = b.submit(*QUERIES[0], k=3).result(timeout=120)
    st = b.stats()
    for ours, ref in zip(batched, sequential):
        _assert_same(ours, ref)
    _assert_same(short, batched[0][:3])
    assert st["queries"] == len(QUERIES) + 1
    assert st["dispatches"] < st["queries"]  # coalesced
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("late")


def test_batching_backpressure_and_k_bound(setup):
    _, tr = _pair(setup)
    gate = threading.Event()
    real = tr.search

    def slow_search(*a, **kw):
        gate.wait(timeout=60)
        return real(*a, **kw)

    tr.search = slow_search
    b = BatchingRetriever(tr, max_batch=1, max_wait_ms=0.0, queue_depth=1)
    try:
        with pytest.raises(ValueError, match="top_k"):
            b.submit("q", k=9)
        first = b.submit("one")
        with pytest.raises(BacklogFull):
            for _ in range(5):
                b.submit("more")
        gate.set()
        assert first.result(timeout=120)
    finally:
        gate.set()
        b.close()


def test_unported_modes_raise(setup):
    for kw in ({"ivf": True},):
        with pytest.raises(NotImplementedError):
            Retriever(setup["tok"], setup["params"], setup["cfg"], setup["store"], **kw)


@pytest.mark.parametrize("dtype, atol", [("float32", 2e-3), ("bfloat16", 0.03)])
def test_int8_tower_retriever_matches_jax(setup, dtype, atol):
    """encoder_int8=True in both packages (a bfloat16 carry routes the
    port through the fused LayerNorm-quant and MLP twins).  The query
    embeddings agree within 2e-3 (float32 carry, as in
    test_torch_encoder_int8.py) or 0.03 (bfloat16 carry: measured 2.0e-2,
    cosine 0.99997; the float bfloat16 tower differs from JAX's by 1.9e-2
    on these queries, so the gap is the carry's rounding, not int8's).
    A passage score then moves by at most
    delta = max |(q_port - q_jax) . p| over the store, so every rank whose
    score lies more than 2 delta from both neighbours holds the same pid,
    and the scores agree within delta."""
    cfg = dataclasses.replace(setup["cfg"], dtype=dtype)
    kw = dict(
        offset2pid=setup["offset2pid"], data_cfg=setup["data_cfg"],
        search_cfg=SearchConfig(top_k=8), encoder_int8=True,
    )
    jr = JaxRetriever(setup["tok"], setup["params"], cfg, setup["store"], **kw)
    tr = Retriever(setup["tok"], setup["params"], cfg, setup["store"], **kw, device="cpu")
    assert tr.encoder.int8
    exs = [tr.build_query(q, h) for q, h in QUERIES]
    qt, qj = tr.embed(exs), jr.embed(exs)
    np.testing.assert_allclose(qt, qj, atol=atol, rtol=0)
    emb = np.concatenate([setup["store"].read_block(b)[0] for b in range(setup["store"].num_blocks())])
    delta = np.abs((qt - qj) @ emb.T).max(axis=1) + 1e-5
    separated = 0
    for n, (question, history) in enumerate(QUERIES):
        ours, ref = tr.retrieve(question, history), jr.retrieve(question, history)
        np.testing.assert_allclose([s for _, s in ours], [s for _, s in ref], atol=delta[n], rtol=0)
        full = np.sort(qj[n] @ emb.T)[::-1]
        for j in range(len(ref)):
            above = full[j - 1] - full[j] if j else np.inf
            if min(above, full[j] - full[j + 1]) > 2 * delta[n]:
                assert ours[j][0] == ref[j][0]
                separated += 1
    assert separated >= len(QUERIES) * 4  # most ranks are separated


def test_retriever_over_a_device_tensor(setup):
    rng = np.random.RandomState(0)
    emb = torch.from_numpy(rng.randn(50, setup["cfg"].embedding_dim).astype(np.float32))
    tr = Retriever(
        setup["tok"], setup["params"], setup["cfg"], emb,
        data_cfg=setup["data_cfg"], search_cfg=SearchConfig(top_k=5), device="cpu",
    )
    q = tr.embed([tr.build_query("hello there")])
    s, i = tr.search(q)
    ref = np.argsort(-(q @ emb.numpy().T), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(i, ref)
    with pytest.raises(ValueError, match="EmbeddingBlockStore"):
        Retriever(
            setup["tok"], setup["params"], setup["cfg"], emb,
            data_cfg=setup["data_cfg"],
            search_cfg=SearchConfig(top_k=5, rescore_oversample=2.0), device="cpu",
        ).search(q)
