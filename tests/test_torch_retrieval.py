"""The offline evaluation slice of the PyTorch port (haconvdr_torch/
retrieval.py) against the JAX reference (haconvdr_tpu/retrieval.py) on
tests/test_e2e.py's fixture: a tiny encoder (weights 10x the reference
init's, so that scores separate), 50 passages tokenized and
encoded by the JAX package into 4 blocks (16, 16, 16, 2), one shared
tokenizer, the JAX params carried over by AnceEncoder.from_jax_params.
Each flow runs end to end in both packages, each with its own encoder and
search, over the float store (per-block search) and over the same rows as
int8 blocks searched through the int8 super-block accumulator.

Pass conditions: equal test examples; query embeddings within 1e-5
(float32 towers, sums in another order); TREC files identical in columns
1-5 (qid, Q0, pid, rank, 200 - rank) with the score column within 1e-5
relative; equal metric dicts; equal PRJ labels.  Identical ranks need the
adjacent scores of a query to differ by more than the two packages'
scores can: the test checks that margin first.
"""

import json
import os

import jax
import numpy as np
import pytest

from haconvdr_torch import retrieval as t_retrieval
from haconvdr_torch.config import DataConfig as TDataConfig
from haconvdr_torch.config import ExperimentConfig as TExperimentConfig
from haconvdr_torch.config import SearchConfig as TSearchConfig
from haconvdr_torch.index.store import EmbeddingBlockStore as TStore
from haconvdr_torch.models.encoder import AnceEncoder
from haconvdr_torch.ops import fused_topk, topk_v4
from haconvdr_tpu import retrieval as j_retrieval
from haconvdr_tpu.config import DataConfig, ExperimentConfig, IndexConfig, ModelConfig, SearchConfig
from haconvdr_tpu.index.build import encode_corpus, tokenize_collection
from haconvdr_tpu.index.quantize import quantize_int8
from haconvdr_tpu.index.store import EmbeddingBlockStore
from haconvdr_tpu.models.encoder import init_encoder_params
from haconvdr_tpu.parallel.mesh import make_mesh
from haconvdr_tpu.parallel.sharded_encode import make_sharded_encode_fn, shard_params
from haconvdr_tpu.utils.io import pstore
from haconvdr_tpu.utils.testing import FakeTokenizer

N_PASSAGES = 50
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
GOLD = [3, 17, 25, 42, 49, 8, 31, 12]  # two conversations of four turns
LENGTHS = dict(max_query_length=16, max_doc_length=16, max_concat_length=24)


def _passage_text(pid):
    return " ".join(WORDS[(pid + j) % len(WORDS)] for j in range(4)) + f" tok{pid}"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_retrieval")
    coll = tmp / "collection.tsv"
    with open(coll, "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in range(1, N_PASSAGES + 1):
            f.write(f"{pid}\t{_passage_text(pid)}\ttitle {pid}\n")
    tok = FakeTokenizer()
    mcfg = ModelConfig.tiny(vocab_size=512)
    corpus = tokenize_collection(
        IndexConfig(raw_collection_path=str(coll), data_output_path=str(tmp / "tokenized"),
                    max_seq_length=16, num_tokenize_workers=1),
        tokenizer=tok,
    )
    mesh = make_mesh()
    # the JAX init with every dense kernel and the word embeddings 10x
    # wider (std 0.2): at std 0.02 all 50 embeddings agree to ~1e-5 and the
    # scores of one query sit a float32 ulp apart, so no two float32
    # implementations could agree on their order
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * (10 if path[-1].key in ("kernel", "word_embeddings")
                                          else 1),
        init_encoder_params(jax.random.PRNGKey(0), mcfg),
    )
    store = encode_corpus(
        corpus, make_sharded_encode_fn(mesh, mcfg), shard_params(mesh, params),
        str(tmp / "embeds"), batch_size=16, per_block_passage_num=24,
    )
    assert store.num_blocks() == 4
    store8 = EmbeddingBlockStore(str(tmp / "embeds8"))
    for b, (emb, ids) in enumerate(store.iter_blocks()):
        codes, scale = quantize_int8(np.asarray(emb, np.float32))
        store8.write_block(b, codes, ids, scale=scale)
    offset2pid = corpus.offset2pid()
    pstore(offset2pid, str(tmp / "offset2pid.pickle"))
    # TopiOCQA test records: each conversation's first turn is its gold
    # passage's own text; later turns carry every prior turn (use_PRL off)
    test_file = tmp / "test.json"
    qrel_file = tmp / "qrel.trec"
    with open(test_file, "w") as f, open(qrel_file, "w") as g:
        for i, pid in enumerate(GOLD):
            conv, turn = i // 4 + 1, i % 4 + 1
            text = _passage_text(pid) if turn == 1 else f"what about {WORDS[i % 8]} tok{pid}"
            f.write(json.dumps({
                "sample_id": f"E2E_{conv}_{turn}", "cur_utt_text": text, "last_response": "",
                "pos_docs": [_passage_text(pid)], "pos_docs_pids": [pid],
                "rel_label": [1] * (turn - 1),
            }) + "\n")
            g.write(f"E2E_{conv}_{turn} 0 {pid} 1\n")
    encoder = AnceEncoder.from_jax_params(params, mcfg, "cpu")
    return dict(tmp=tmp, tok=tok, mcfg=mcfg, params=params, mesh=mesh, encoder=encoder,
                offset2pid=offset2pid, test_file=str(test_file), qrel_file=str(qrel_file))


STORES = {
    "float": dict(passages="embeds"),
    "int8 superblock": dict(passages="embeds8", superblock_rows=24, superblock_dtype="int8"),
}


def _configs(env, store, out, **data_kw):
    """The same experiment config in both packages' classes."""
    kw = dict(STORES[store])
    search = dict(
        passage_embeddings_dir_path=str(env["tmp"] / kw.pop("passages")),
        top_k=10, qrel_output_path=str(env["tmp"] / out), output_trec_file="res.trec",
        trec_gold_qrel_file_path=env["qrel_file"], passage_chunk=8, query_chunk=4,
        per_device_test_batch_size=2, **kw,
    )
    if store != "float":  # the offset map read back from its path
        search["passage_offset2pid_path"] = str(env["tmp"] / "offset2pid.pickle")
    data = dict(dict(dataset="topiocqa", test_file_path=env["test_file"], is_train=False,
                     use_PRL=False, **LENGTHS), **data_kw)
    return (
        ExperimentConfig(data=DataConfig(**data), model=env["mcfg"],
                         search=SearchConfig(**search)),
        TExperimentConfig(data=TDataConfig(**data), model=env["mcfg"],
                          search=TSearchConfig(**search)),
    )


def _read_trec(path):
    with open(path) as f:
        rows = [line.split() for line in f]
    return [r[:5] + r[6:] for r in rows], np.array([float(r[5]) for r in rows])


def _check_margin(path, store, cfg, embs_t, embs_j):
    """Identical ranks need every adjacent pair of a query's scores to
    differ by more than the two packages' scores can: float32 summation
    order (D 2**-24 |q| |p| on each side) plus, over the float store, the
    embeddings' difference times the largest row norm.  Over the int8
    store both packages score the bfloat16-rounded folded queries: those
    must round alike."""
    cols, scores = _read_trec(path)
    st = TStore(cfg.search.passage_embeddings_dir_path)
    rows = np.concatenate([e for e, _ in st.iter_blocks()])  # int8 dequantized
    p_norm = float(np.linalg.norm(rows, axis=1).max())
    if store == "float":
        moved = float(np.linalg.norm(embs_t - embs_j, axis=1).max()) * p_norm
    else:
        import torch

        scale = torch.from_numpy(st.global_scale())
        folded = [(torch.from_numpy(e) * scale).bfloat16() for e in (embs_t, embs_j)]
        assert torch.equal(*folded)
        moved = 0.0
    dim = embs_j.shape[1]
    order = 2 * dim * 2.0**-24 * float(np.linalg.norm(embs_j, axis=1).max()) * p_norm
    for j in range(len(cols) - 1):
        if cols[j][0] == cols[j + 1][0] and "0" not in (cols[j][2], cols[j + 1][2]):
            assert abs(scores[j] - scores[j + 1]) > 2 * moved + order


@pytest.mark.parametrize("store", list(STORES))
def test_offline_eval_matches_jax(env, store):
    jcfg, tcfg = _configs(env, store, f"out-{store}")
    ex_j = j_retrieval.build_test_examples(jcfg, env["tok"])
    ex_t = t_retrieval.build_test_examples(tcfg, env["tok"])
    assert ex_t == ex_j and len(ex_t) == len(GOLD)
    embs_j, ids_j = j_retrieval.get_test_query_embeddings(jcfg, env["params"], mesh=env["mesh"],
                                                          examples=ex_j)
    for mod in (fused_topk, topk_v4):
        mod.COUNTS.update({key: 0 for key in mod.COUNTS})
    embs_t, ids_t = t_retrieval.get_test_query_embeddings(tcfg, env["encoder"], examples=ex_t)
    assert ids_t == ids_j == [e["sample_id"] for e in ex_j]
    emb_err = float(np.abs(embs_t - embs_j).max())
    assert embs_t.shape == embs_j.shape and emb_err <= 1e-5

    o2p = env["offset2pid"] if store == "float" else None
    res_j = j_retrieval.gen_metric_score_and_save(jcfg, embs_j, ids_j, offset2pid=o2p)
    res_t = t_retrieval.gen_metric_score_and_save(tcfg, embs_t, ids_t, offset2pid=o2p,
                                                  device="cpu")
    assert fused_topk.COUNTS["plain"] > 0 and fused_topk.COUNTS["kernel"] == 0
    trec = os.path.join(tcfg.search.qrel_output_path, "res.trec")
    jtrec = os.path.join(jcfg.search.qrel_output_path, "res.trec")
    _check_margin(jtrec, store, tcfg, embs_t, embs_j)
    (cols, scores), (jcols, jscores) = _read_trec(trec), _read_trec(jtrec)
    assert cols == jcols and len(cols) == len(GOLD) * 10
    np.testing.assert_allclose(scores, jscores, rtol=1e-5)
    assert res_t == res_j and set(res_t) >= {"MRR", "NDCG@3", "Recall@10", "Recall@100"}
    if store == "float":  # the first turns are their golds' own text
        assert [c[2] for c in cols[::10]][::4] == [str(GOLD[0]), str(GOLD[4])]


def _probes():
    """Conversations 7 and 8 as tests/test_e2e.py has them, and conversation
    9 whose probes 1 and 2 pair the question with its gold's own text."""
    p = [
        ("7-2-0", _passage_text(12), "", 12), ("7-2-1", _passage_text(12), "unrelated words", 12),
        ("8-2-0", "some other question", "", 20),
        ("8-2-1", "some other question", _passage_text(20), 20),
        ("9-3-0", "and then", "", 33), ("9-3-1", "and then", _passage_text(33), 33),
        ("9-3-2", "and then", "beta gamma", 33),
    ]
    return [{"id": i, "conv_id": int(i[0]), "turn_id": int(i[2]), "query": q, "query_pair": qp,
             "pos_docs_id": [pid], "last_response": ""} for i, q, qp, pid in p]


@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("store", list(STORES))
def test_prj_labeling_matches_jax(env, store, precomputed):
    jcfg, tcfg = _configs(env, store, f"prj-{store}", max_concat_length=48)
    probes = _probes()
    qrel = env["tmp"] / "probe_qrel.trec"
    qrel.write_text("".join(f"{p['id']} Q0 {p['pos_docs_id'][0]} 1\n" for p in probes))
    o2p = env["offset2pid"] if store == "float" else None
    common = dict(offset2pid=o2p)
    embs = ids = None
    if precomputed:  # the cross-validate form: the same embeddings to both
        from haconvdr_tpu.data.prj import build_prj_probe_examples

        path = env["tmp"] / "probes.json"
        path.write_text("".join(json.dumps(p) + "\n" for p in probes))
        ex = build_prj_probe_examples(jcfg.data, env["tok"], str(path))
        embs, ids = j_retrieval.get_test_query_embeddings(
            jcfg, env["params"], mesh=env["mesh"], examples=ex, query_key="pair_query")
        common.update(query_embs=embs, query_ids=ids)
    rel_j = j_retrieval.run_prj_labeling(jcfg, env["params"], probes, str(qrel), env["tok"],
                                         mesh=env["mesh"], **common)
    rel_t = t_retrieval.run_prj_labeling(tcfg, None if precomputed else env["encoder"], probes,
                                         str(qrel), env["tok"], device="cpu", **common)
    assert rel_t == rel_j
    assert set(rel_t) == {"7-1", "7-2", "8-1", "8-2", "9-1", "9-3"}
    assert rel_t["7-2"] == [0] and len(rel_t["9-3"]) == 2
    assert 1 in sum(rel_t.values(), [])  # a probe that beats its base
    t_retrieval.write_rel_labels(rel_t, str(env["tmp"] / "t.jsonl"))
    j_retrieval.write_rel_labels(rel_j, str(env["tmp"] / "j.jsonl"))
    assert (env["tmp"] / "t.jsonl").read_bytes() == (env["tmp"] / "j.jsonl").read_bytes()


def test_search_embedding_store_block_limit_and_superblocks(env, rng):
    """passage_block_num truncates the scan; super-blocks equal per-block;
    both as the JAX package's search_embedding_store returns them."""
    queries = rng.randn(3, env["mcfg"].embedding_dim).astype(np.float32)
    base = dict(passage_embeddings_dir_path=str(env["tmp"] / "embeds"), top_k=5,
                passage_chunk=8, query_chunk=4)
    for extra in (dict(passage_block_num=2), dict(superblock_rows=24), {}):
        jcfg = ExperimentConfig(search=SearchConfig(**base, **extra))
        tcfg = TExperimentConfig(search=TSearchConfig(**base, **extra))
        js, ji = j_retrieval.search_embedding_store(jcfg, queries)
        ts, ti = t_retrieval.search_embedding_store(tcfg, queries, TStore(base[
            "passage_embeddings_dir_path"]), device="cpu")
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5)
        if extra.get("passage_block_num") == 2:
            assert ti.max() < 32


def test_retrieval_runs_on_the_card_unless_told_cpu(env, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs(env, "float", "nocard")
    with pytest.raises(RuntimeError, match="is_available"):
        t_retrieval.search_embedding_store(tcfg, np.zeros((1, env["mcfg"].embedding_dim),
                                                          np.float32))
