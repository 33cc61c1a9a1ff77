"""The whole serving slice of the PyTorch port (haconvdr_torch/serve.py)
against the JAX reference (haconvdr_tpu/serve.py): one shared-writer
EmbeddingBlockStore, one tokenizer, the same numpy encoder weights.
Pass conditions: identical ranked pids for conversational queries with
scores within 1e-5; BatchingRetriever answers equal the sequential path;
the two-stage rescore path agrees with JAX."""

import threading

import numpy as np
import pytest
import torch

from haconvdr_tpu.config import DataConfig, ModelConfig, SearchConfig
from haconvdr_tpu.index.store import EmbeddingBlockStore
from haconvdr_tpu.serve import Retriever as JaxRetriever
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
    return dict(
        tok=HashTokenizer(cfg.vocab_size), cfg=cfg, params=params, store=store,
        offset2pid=offset2pid, data_cfg=data_cfg,
    )


def _pair(setup, **search_kw):
    kw = dict(
        offset2pid=setup["offset2pid"], data_cfg=setup["data_cfg"],
        search_cfg=SearchConfig(top_k=8, per_device_test_batch_size=2, **search_kw),
    )
    jr = JaxRetriever(setup["tok"], setup["params"], setup["cfg"], setup["store"], **kw)
    tr = Retriever(setup["tok"], setup["params"], setup["cfg"], setup["store"], **kw)
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
        search_cfg=SearchConfig(top_k=8), resident=False,
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
    for kw in ({"ivf": True}, {"encoder_int8": True}, {"store_dtype": "int8"}):
        with pytest.raises(NotImplementedError):
            Retriever(setup["tok"], setup["params"], setup["cfg"], setup["store"], **kw)


def test_retriever_over_a_device_tensor(setup):
    rng = np.random.RandomState(0)
    emb = torch.from_numpy(rng.randn(50, setup["cfg"].embedding_dim).astype(np.float32))
    tr = Retriever(
        setup["tok"], setup["params"], setup["cfg"], emb,
        data_cfg=setup["data_cfg"], search_cfg=SearchConfig(top_k=5),
    )
    q = tr.embed([tr.build_query("hello there")])
    s, i = tr.search(q)
    ref = np.argsort(-(q @ emb.numpy().T), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(i, ref)
    with pytest.raises(ValueError, match="EmbeddingBlockStore"):
        Retriever(
            setup["tok"], setup["params"], setup["cfg"], emb,
            data_cfg=setup["data_cfg"],
            search_cfg=SearchConfig(top_k=5, rescore_oversample=2.0),
        ).search(q)
