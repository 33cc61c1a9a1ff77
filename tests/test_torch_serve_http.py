"""RetrievalServer of the PyTorch port (haconvdr_torch/serve_http.py)
against tests/test_serve_http.py's contract for the JAX package's: HTTP
results equal the in-process sequential Retriever.retrieve path,
concurrent HTTP clients coalesce through the batcher into fewer
dispatches, malformed input gets 4xx (never a hang or a 500), a full
backlog gets 503 with Retry-After and a stalled dispatch 504, /stats and
/healthz report truthfully, and close() drains in-flight work and is
idempotent.  The port's Retriever runs on ``device="cpu"`` over a store
its own ``encode_corpus`` wrote.  One more test starts the JAX server and
the port's over the same params, store and tokenizer: the same requests
get the same ids, with scores within 1e-5.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from haconvdr_torch.config import DataConfig, IndexConfig, ModelConfig, SearchConfig
from haconvdr_torch.index.build import encode_corpus, tokenize_collection
from haconvdr_torch.index.store import EmbeddingBlockStore
from haconvdr_torch.models.convert import init_params_numpy
from haconvdr_torch.models.encoder import AnceEncoder
from haconvdr_torch.serve import Retriever
from haconvdr_torch.serve_http import RetrievalServer
from haconvdr_torch.utils.testing import HashTokenizer

N_PASSAGES = 40
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]


def _passage_text(pid):
    return " ".join(WORDS[(pid + j) % len(WORDS)] for j in range(4)) + f" tok{pid}"


DATA_CFG = dict(
    is_train=False, use_PRL=False,
    max_query_length=16, max_doc_length=16, max_concat_length=24,
)
SEARCH_CFG = dict(top_k=5, per_device_test_batch_size=1, passage_chunk=8, query_chunk=4)


def _widen(tree, key=""):
    if isinstance(tree, dict):
        return {k: _widen(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widen(v) for v in tree]
    return tree * 10 if key in ("kernel", "word_embeddings") else tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve_http")
    coll = tmp / "collection.tsv"
    with open(coll, "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in range(1, N_PASSAGES + 1):
            f.write(f"{pid}\t{_passage_text(pid)}\ttitle {pid}\n")
    mcfg = ModelConfig.tiny(vocab_size=512)
    tok = HashTokenizer(mcfg.vocab_size)
    icfg = IndexConfig(
        raw_collection_path=str(coll), data_output_path=str(tmp / "tokenized"),
        max_seq_length=16, num_tokenize_workers=1,
    )
    corpus = tokenize_collection(icfg, tokenizer=tok)
    # every dense kernel and the word embeddings 10x wider (std 0.2), as
    # tests/test_torch_retrieval.py does: at std 0.02 the 40 embeddings
    # agree to ~1e-6, and a passage's own text need not rank it first
    params = _widen(init_params_numpy(mcfg, seed=0))
    encode_corpus(
        corpus, AnceEncoder.from_jax_params(params, mcfg, "cpu"), str(tmp / "embeds"),
        batch_size=16, per_block_passage_num=24,
    )
    return dict(tok=tok, mcfg=mcfg, params=params, offset2pid=corpus.offset2pid(),
                store=EmbeddingBlockStore(str(tmp / "embeds")))


@pytest.fixture(scope="module")
def retriever(setup):
    return Retriever(
        setup["tok"], setup["params"], setup["mcfg"], setup["store"],
        offset2pid=setup["offset2pid"], data_cfg=DataConfig(**DATA_CFG),
        search_cfg=SearchConfig(**SEARCH_CFG), resident=True, device="cpu",
    )


@pytest.fixture()
def server(retriever):
    srv = RetrievalServer(
        retriever, port=0, max_batch=8, max_wait_ms=200.0
    ).start()
    yield srv
    srv.close()


def _post(srv, path, obj, timeout=60):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(srv, path, timeout=30):
    with urllib.request.urlopen(
        f"http://{srv.host}:{srv.port}{path}", timeout=timeout
    ) as r:
        return r.status, json.loads(r.read())


def test_retrieve_matches_sequential(server, retriever):
    gold = 11
    seq = retriever.retrieve(_passage_text(gold))
    code, obj = _post(server, "/retrieve", {"question": _passage_text(gold)})
    assert code == 200
    hits = [(h["pid"], h["score"]) for h in obj["hits"]]
    assert hits[0][0] == gold and seq[0][0] == gold
    np.testing.assert_allclose(
        [s for _, s in hits], [s for _, s in seq], rtol=1e-4, atol=1e-5
    )
    assert obj["latency_ms"] > 0


def test_history_and_k_forwarded(server, retriever):
    """history/history_passages/k reach build_query exactly as the
    in-process API would pass them."""
    q = {
        "question": _passage_text(7),
        "history": [[_passage_text(3), "an answer"]],
        "history_passages": [_passage_text(5)],
        "k": 2,
    }
    code, obj = _post(server, "/retrieve", q)
    assert code == 200
    assert len(obj["hits"]) == 2
    seq = retriever.retrieve(
        q["question"], [tuple(q["history"][0])], q["history_passages"], k=2
    )
    assert [h["pid"] for h in obj["hits"]] == [p for p, _ in seq]


def test_concurrent_clients_coalesce(server, retriever):
    """N parallel HTTP clients form fewer device dispatches than queries —
    the server's whole point."""
    golds = [3, 17, 25, 31, 8, 12]
    before = server.batcher.stats()["dispatches"]
    out = {}

    def ask(pid):
        out[pid] = _post(server, "/retrieve", {"question": _passage_text(pid)})

    threads = [threading.Thread(target=ask, args=(p,)) for p in golds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for pid in golds:
        code, obj = out[pid]
        assert code == 200
        assert obj["hits"][0]["pid"] == pid
    st = server.batcher.stats()
    assert st["dispatches"] - before < len(golds)


def test_retrieve_batch_one_client(server):
    """A single client's /retrieve_batch coalesces like concurrent clients
    and keeps per-query validity (a bad query errors alone)."""
    golds = [5, 9, 14]
    queries = [{"question": _passage_text(p)} for p in golds]
    queries.insert(1, {"question": ""})  # invalid: must not fail the rest
    code, obj = _post(server, "/retrieve_batch", {"queries": queries})
    assert code == 200
    res = obj["results"]
    assert "error" in res[1]
    for pid, r in zip(golds, [res[0]] + res[2:]):
        assert r["hits"][0]["pid"] == pid


def test_bad_input_is_4xx(server):
    for path, body, want in [
        ("/retrieve", {"question": 3}, 400),
        ("/retrieve", {"question": "x", "history": [["only-q"]]}, 400),
        ("/retrieve", {"question": "x", "k": 0}, 400),
        ("/retrieve_batch", {"queries": []}, 400),
        ("/nope", {"question": "x"}, 404),
    ]:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, path, body)
        assert ei.value.code == want
        assert "error" in json.loads(ei.value.read())
    # malformed JSON body
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}/retrieve",
        data=b"{not json",
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_health_and_stats(server):
    code, h = _get(server, "/healthz")
    assert code == 200 and h["ok"] is True and h["uptime_s"] >= 0
    _post(server, "/retrieve", {"question": _passage_text(21)})
    code, st = _get(server, "/stats")
    assert code == 200
    assert st["served"] >= 1
    assert st["latency_ms"]["p50"] > 0
    assert st["latency_ms"]["p99"] >= st["latency_ms"]["p50"]
    assert "dispatches" in st and "batch_histogram" in st


class _BlockingSearchRetriever:
    """Delegate everything to a real Retriever but gate search() on an
    event — simulates a stalled device dispatch (the failure mode the
    backpressure contract exists for)."""

    def __init__(self, inner):
        self._inner = inner
        self.entered = threading.Event()
        self.release = threading.Event()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def search(self, embs):
        self.entered.set()
        assert self.release.wait(timeout=120), "test forgot to release"
        return self._inner.search(embs)


def test_backlog_full_is_503_with_retry_after(retriever):
    """With the dispatch worker stalled and the bounded queue full,
    further submits shed load: 503 + Retry-After, served instantly (not
    queued behind the stall).  Queued requests still complete once the
    stall clears."""
    proxy = _BlockingSearchRetriever(retriever)
    srv = RetrievalServer(
        proxy, port=0, max_batch=1, max_wait_ms=0.0,
        queue_depth=2, request_timeout_s=120.0,
    ).start()
    try:
        results = {}

        def ask(i, pid):
            results[i] = _post(
                srv, "/retrieve", {"question": _passage_text(pid)},
                timeout=120,
            )

        t0 = threading.Thread(target=ask, args=(0, 3))
        t0.start()
        assert proxy.entered.wait(timeout=60)  # r0 stalled inside dispatch
        ts = [
            threading.Thread(target=ask, args=(i, 3 + i)) for i in (1, 2)
        ]
        for t in ts:
            t.start()
        deadline = time.time() + 30
        while (
            srv.batcher.stats()["backlog"] < 2 and time.time() < deadline
        ):
            time.sleep(0.01)
        assert srv.batcher.stats()["backlog"] == 2  # queue at queue_depth

        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, "/retrieve", {"question": _passage_text(9)})
        assert ei.value.code == 503
        assert float(ei.value.headers["Retry-After"]) > 0
        assert "backlog" in json.loads(ei.value.read())["error"]

        proxy.release.set()  # stall clears; queued requests drain
        for t in [t0] + ts:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, pid in [(0, 3), (1, 4), (2, 5)]:
            code, obj = results[i]
            assert code == 200 and obj["hits"][0]["pid"] == pid
    finally:
        proxy.release.set()
        srv.close()


def test_stalled_dispatch_times_out_504(retriever):
    """A request whose dispatch stalls past request_timeout_s gets 504
    (request threads are never pinned indefinitely); the late-completing
    dispatch is skipped via the cancelled future, and the server keeps
    serving afterwards."""
    proxy = _BlockingSearchRetriever(retriever)
    srv = RetrievalServer(
        proxy, port=0, max_batch=4, request_timeout_s=0.3
    ).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, "/retrieve", {"question": _passage_text(5)},
                  timeout=60)
        assert ei.value.code == 504
        assert "timed out" in json.loads(ei.value.read())["error"]
        _, st = _get(srv, "/stats")
        assert st["errors"] >= 1

        proxy.release.set()  # the stalled dispatch completes harmlessly
        code, obj = _post(
            srv, "/retrieve", {"question": _passage_text(7)}, timeout=60
        )
        assert code == 200 and obj["hits"][0]["pid"] == 7
    finally:
        proxy.release.set()
        srv.close()


def test_graceful_drain_under_concurrent_load(retriever):
    """close() racing 16 concurrent clients: every client gets a
    definitive outcome (200 with correct hits, 503, or a connection
    error for arrivals after the listener stopped) — nothing hangs."""
    srv = RetrievalServer(
        retriever, port=0, max_batch=4, max_wait_ms=20.0
    ).start()
    outcomes = []
    lock = threading.Lock()

    def ask(pid):
        try:
            code, obj = _post(
                srv, "/retrieve", {"question": _passage_text(pid)},
                timeout=120,
            )
            o = ("ok", pid, obj)
        except urllib.error.HTTPError as e:
            o = ("http", pid, e.code)
        except (urllib.error.URLError, ConnectionError, OSError):
            o = ("conn", pid, None)
        with lock:
            outcomes.append(o)

    threads = [
        threading.Thread(target=ask, args=(1 + i % 20,)) for i in range(16)
    ]
    for t in threads:
        t.start()
    srv.close()  # concurrent with in-flight requests
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads), (
        "a request hung through close()"
    )
    assert len(outcomes) == 16
    for kind, pid, obj in outcomes:
        if kind == "ok":  # accepted before close: full correct answer
            assert obj["hits"][0]["pid"] == pid
        elif kind == "http":  # rejected cleanly
            assert obj in (503, 504)


def test_close_is_idempotent_and_refuses_after(retriever):
    srv = RetrievalServer(retriever, port=0, max_batch=4).start()
    code, obj = _post(srv, "/retrieve", {"question": _passage_text(6)})
    assert code == 200
    srv.close()
    srv.close()  # idempotent
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _post(srv, "/retrieve", {"question": _passage_text(6)}, timeout=5)
    idle = RetrievalServer(retriever, port=0)  # never started: close() returns
    done = threading.Thread(target=idle.close)
    done.start()
    done.join(timeout=30)
    assert not done.is_alive()


def test_a_burst_of_concurrent_connections_is_answered(retriever):
    """128 clients connect at one instant (a barrier): every one gets its
    answer.  The listen backlog is 1,024 (the stdlib's 5 resets such a
    burst's connections, as the JAX package's server does)."""
    srv = RetrievalServer(retriever, port=0, max_batch=16, max_wait_ms=5.0).start()
    n = 128
    gate = threading.Barrier(n)
    out = [None] * n

    def ask(j):
        gate.wait()
        out[j] = _post(srv, "/retrieve", {"question": _passage_text(1 + j % N_PASSAGES)})

    try:
        threads = [threading.Thread(target=ask, args=(j,)) for j in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        _, st = _get(srv, "/stats")
    finally:
        srv.close()
    for j, res in enumerate(out):
        assert res is not None and res[0] == 200
        assert res[1]["hits"][0]["pid"] == 1 + j % N_PASSAGES
    assert st["served"] == n and st["errors"] == 0 and st["dispatches"] < n


class _BorrowingTokenizer(HashTokenizer):
    """HashTokenizer that fails as a Rust-backed HF tokenizer does when two
    threads encode at once: RuntimeError("Already borrowed")."""

    def __init__(self, vocab_size):
        super().__init__(vocab_size)
        self._busy = threading.Lock()

    def encode(self, *args, **kw):
        if not self._busy.acquire(blocking=False):
            raise RuntimeError("Already borrowed")
        try:
            time.sleep(0.001)  # hold it long enough for a burst to overlap
            return super().encode(*args, **kw)
        finally:
            self._busy.release()


def test_concurrent_clients_share_one_tokenizer(setup, retriever):
    """32 clients at one instant through a tokenizer that refuses to be
    entered twice: every answer is 200 and agrees with the sequential path
    as test_retrieve_matches_sequential holds it (handler threads build
    their queries one at a time)."""
    r = Retriever(
        _BorrowingTokenizer(setup["mcfg"].vocab_size), setup["params"], setup["mcfg"],
        setup["store"], offset2pid=setup["offset2pid"], data_cfg=DataConfig(**DATA_CFG),
        search_cfg=SearchConfig(**SEARCH_CFG), resident=True, device="cpu",
    )
    srv = RetrievalServer(r, port=0, max_batch=8, max_wait_ms=5.0).start()
    n = 32
    gate = threading.Barrier(n)
    out = [None] * n
    body = [{"question": _passage_text(1 + j % N_PASSAGES),
             "history": [[_passage_text(2 + j % 7), "yes"]]} for j in range(n)]

    def ask(j):
        gate.wait()
        try:
            out[j] = _post(srv, "/retrieve", body[j])
        except urllib.error.HTTPError as e:
            out[j] = (e.code, json.loads(e.read()))

    try:
        threads = [threading.Thread(target=ask, args=(j,)) for j in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        _, st = _get(srv, "/stats")
    finally:
        srv.close()
    assert [res[0] for res in out] == [200] * n, [res for res in out if res[0] != 200][:2]
    for j, (_, res) in enumerate(out):
        want = retriever.retrieve(body[j]["question"], [tuple(body[j]["history"][0])])
        assert [h["pid"] for h in res["hits"]] == [p for p, _ in want]
        np.testing.assert_allclose(
            [h["score"] for h in res["hits"]], [x for _, x in want], rtol=1e-4, atol=1e-5
        )
    assert st["served"] == n and st["errors"] == 0


def test_answers_match_the_jax_server(setup, tmp_path):
    """The JAX package's RetrievalServer and the port's, over the same
    params, store and tokenizer: the same ids for the same requests
    (single, with history and k, and one batch), scores within 1e-5.  The
    store holds N(0, 1) rows (two blocks): the encoded passages of the
    other tests score within ~1e-5 of each other, too close to rank the
    same in two float32 towers."""
    from haconvdr_tpu.config import DataConfig as JaxDataConfig
    from haconvdr_tpu.config import SearchConfig as JaxSearchConfig
    from haconvdr_tpu.serve import Retriever as JaxRetriever
    from haconvdr_tpu.serve_http import RetrievalServer as JaxRetrievalServer

    rng = np.random.default_rng(4)
    store = EmbeddingBlockStore(str(tmp_path / "emb"))
    for b, n in enumerate((30, 20)):
        rows = rng.standard_normal((n, setup["mcfg"].embedding_dim)).astype(np.float32)
        store.write_block(b, rows, np.arange(30 * b, 30 * b + n, dtype=np.int64))
    offset2pid = [100 + 3 * i for i in range(50)]
    kw = dict(offset2pid=offset2pid, resident=True)
    jr = JaxRetriever(
        setup["tok"], setup["params"], setup["mcfg"], store, **kw,
        data_cfg=JaxDataConfig(**DATA_CFG), search_cfg=JaxSearchConfig(**SEARCH_CFG),
    )
    tr = Retriever(
        setup["tok"], setup["params"], setup["mcfg"], store, **kw,
        data_cfg=DataConfig(**DATA_CFG), search_cfg=SearchConfig(**SEARCH_CFG), device="cpu",
    )
    requests = [
        {"question": _passage_text(p)} for p in (3, 17, 26)
    ] + [
        {"question": _passage_text(7), "history": [[_passage_text(3), "an answer"]],
         "history_passages": [_passage_text(5)], "k": 3},
        {"question": "gamma delta", "history": [["alpha beta", "zeta"], ["eta", ""]]},
    ]
    answers = {}
    for name, srv in (
        ("jax", JaxRetrievalServer(jr, port=0, max_batch=4, max_wait_ms=20.0)),
        ("torch", RetrievalServer(tr, port=0, max_batch=4, max_wait_ms=20.0)),
    ):
        with srv.start():
            single = [_post(srv, "/retrieve", q)[1]["hits"] for q in requests]
            _, batch = _post(srv, "/retrieve_batch", {"queries": requests})
        answers[name] = single + [r["hits"] for r in batch["results"]]
    assert len(answers["torch"]) == 2 * len(requests)
    assert [len(a) for a in answers["torch"]] == [5, 5, 5, 3, 5] * 2
    for ours, ref in zip(answers["torch"], answers["jax"]):
        assert [h["pid"] for h in ours] == [h["pid"] for h in ref]
        np.testing.assert_allclose(
            [h["score"] for h in ours], [h["score"] for h in ref], rtol=1e-5, atol=1e-5
        )
