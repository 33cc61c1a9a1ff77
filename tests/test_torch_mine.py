"""The port's BM25 stack (haconvdr_torch/mine/analysis.py, mine/bm25.py,
cli/bm25_search.py) against the JAX package's, and the offline data chain
of tests/test_cli_chain.py run by both packages.

Pass conditions: the same analyzer tokens, stems and NL-query helpers; the
native scorer and its numpy twin agree (ids equal, scores within 1e-5
relative, as tests/test_mine.py holds the JAX pair) and equal the JAX
BM25Index's ranked ids and scores (the same source built with the same
flags); bm25_search writes the same index directory and the same runs,
byte for byte, for every query mode; the chain ends in equal training
examples.  The port builds its scorer under build/haconvdr_torch/
through an atomic replace, never under native/, and a failed build
raises instead of falling back to numpy.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from haconvdr_tpu.mine import analysis as janalysis
from haconvdr_tpu.mine.bm25 import BM25Index as JBM25Index
from haconvdr_torch.mine import analysis as tanalysis
from haconvdr_torch.mine import bm25 as tbm25
from haconvdr_torch.mine.bm25 import BM25Index

TEXTS = [
    "The Quick brown foxes are JUMPING, over 2 lazy dogs!",
    "Relational conditional hopefulness; controlling the generalizations of 1990s",
    "what is the capital of France? And its population...",
    "caresses ponies agreed plastered motoring hopping sized happy vietnamization",
    "",
    "   tabs\tand\nnewlines  ÜNICODE café naïve 42x",
]
WORDS = sorted({w for t in TEXTS for w in t.lower().split()} | {
    "generalization", "oscillators", "rational", "sensibility", "feudalism", "bowdlerize",
    "adjustment", "dependent", "adoption", "homologous", "effective", "formalize", "y", "by"})


@pytest.mark.parametrize("stopwords, stemming", [(True, True), (True, False), (False, True)])
def test_analyzer_matches_jax(stopwords, stemming):
    for text in TEXTS:
        assert tanalysis.analyze(text, stopwords, stemming) == janalysis.analyze(
            text, stopwords, stemming)
    assert [tanalysis.porter_stem(w) for w in WORDS] == [janalysis.porter_stem(w) for w in WORDS]
    assert tanalysis.LUCENE_STOPWORDS == janalysis.LUCENE_STOPWORDS
    for q in ("what is this?", "tell me about x", "how far", "Why not", ""):
        assert tanalysis.is_nl_query(q) == janalysis.is_nl_query(q)
        if q:
            assert tanalysis.format_nl_query(q) == janalysis.format_nl_query(q)


def _docs(n=300, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"term{i}" for i in range(80)] + ["cat", "cats", "dog", "running", "the", "and"]
    return [(f"doc{i}", " ".join(rng.choice(vocab, int(rng.integers(0, 30)))))
            for i in range(n)]


QUERIES = ["cat dog", "term1 term2 term3 term1", "running cats", "the and", "missing words",
           "term79 term5 dog dog", ""]


def _index(cls, docs):
    idx = cls(stemming=True)
    idx.add_many(docs)
    idx.finalize()
    return idx


@pytest.mark.parametrize("k", [1, 10, 500])
def test_bm25_matches_jax_and_its_numpy_twin(k):
    docs = _docs()
    ours, ref = _index(BM25Index, docs), _index(JBM25Index, docs)
    d, s = ours.batch_search(QUERIES, k=k, n_threads=3)
    rd, rs = ref.batch_search(QUERIES, k=k)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(s, rs)
    pd, ps = ours.batch_search(QUERIES, k=k, plain=True)
    np.testing.assert_array_equal(d, pd)
    np.testing.assert_allclose(s, ps, rtol=1e-5)
    assert (d[QUERIES.index("missing words")] == -1).all()
    assert ours.search("cat dog", k=5) == ref.search("cat dog", k=5)


def test_bm25_save_load_matches_jax(tmp_path):
    docs = _docs(50, seed=1)
    _index(BM25Index, docs).save(str(tmp_path / "torch"))
    _index(JBM25Index, docs).save(str(tmp_path / "jax"))
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    back = BM25Index.load(str(tmp_path / "jax"))
    assert back.search("cat term3", k=4) == JBM25Index.load(str(tmp_path / "torch")).search(
        "cat term3", k=4)


def _collection(tmp, n=30):
    path = tmp / "coll.tsv"
    with open(path, "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in range(1, n + 1):
            f.write(f"{pid}\tcontent about topic{pid} item{pid}\tTitle [SEP] {pid}\n")
    return str(path)


SEARCH_MODES = {
    "raw": ["query_type=raw"],
    "rewrite": ["query_type=rewrite"],
    "convq": ["query_type=convq"],
    "convq_prj_turn": ["query_type=convq", "prj_file={prj}"],
    "convq_prj_token": ["query_type=convq", "prj_file={prj}", "level=token"],
    "convqa": ["query_type=convqa"],
    "convqa_prj": ["query_type=convqa", "prj_file={prj}"],
    "convqp": ["query_type=convqp"],
    "decode": ["query_type=decode"],
    "decode_answer": ["query_type=decode", "eval_type=answer", "decode_file={dec}"],
    "decode_oracle_answer": ["query_type=decode", "eval_type=oracle+answer", "decode_file={dec}"],
}


@pytest.fixture(scope="module")
def bm25_inputs(tmp_path_factory):
    from haconvdr_torch.utils.io import write_jsonl

    tmp = tmp_path_factory.mktemp("bm25_cli")
    coll = _collection(tmp)
    recs = [
        {"sample_id": "1_1", "query": "content about topic3", "rewrite": "topic3 item3",
         "oracle_utt_text": "content about topic5", "history_query": [],
         "history_answer": [], "last_response": ""},
        {"sample_id": "1_2", "query": "more about topic7", "rewrite": "",
         "oracle_utt_text": "topic8 item8", "history_query": ["content about topic3"],
         "history_answer": ["item3 answer"], "last_response": "Title 3 content"},
        {"sample_id": "1_3", "query": "and item12", "oracle_utt_text": "item12",
         "history_query": ["content about topic3", "more about topic7"],
         "history_answer": ["item3", "topic7 here"], "last_response": "item7"},
    ]
    write_jsonl(recs, str(tmp / "queries.json"))
    write_jsonl([{"rel_label": []}, {"rel_label": [1]}, {"rel_label": [0, 1]}],
                str(tmp / "prj.json"))
    write_jsonl([{"answer_utt_text": t} for t in ("content about topic9", "item2", "topic4")],
                str(tmp / "dec.json"))
    qrel = tmp / "qrel.trec"
    qrel.write_text("1_1 0 3 1\n1_2 0 7 1\n1_3 0 12 1\n")
    return tmp, coll, qrel


def _run_bm25_cli(main, out, coll, inputs, qrel, mode):
    main(["index", f"data.collection_path={coll}", f"bm25.index_dir_path={out / 'idx'}"])
    extra = [a.format(prj=inputs / "prj.json", dec=inputs / "dec.json")
             for a in SEARCH_MODES[mode]]
    main(["search", f"bm25.index_dir_path={out / 'idx'}",
          f"data.test_file_path={inputs / 'queries.json'}", f"output_trec={out / 'run.trec'}",
          "bm25.top_k=5", f"search.trec_gold_qrel_file_path={qrel}"] + extra)


@pytest.mark.parametrize("mode", list(SEARCH_MODES))
def test_bm25_search_cli_writes_the_jax_files(bm25_inputs, tmp_path, mode):
    from haconvdr_tpu.cli.bm25_search import main as jax_main
    from haconvdr_torch.cli.bm25_search import main as torch_main

    inputs, coll, qrel = bm25_inputs
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        _run_bm25_cli(main, tmp_path / name, coll, inputs, qrel, mode)
    run = (tmp_path / "torch" / "run.trec").read_bytes()
    assert run == (tmp_path / "jax" / "run.trec").read_bytes()
    assert {line.split()[0] for line in run.splitlines()} == {b"1_1", b"1_2", b"1_3"}
    for name in sorted(os.listdir(tmp_path / "jax" / "idx")):
        got = (tmp_path / "torch" / "idx" / name).read_bytes()
        assert got == (tmp_path / "jax" / "idx" / name).read_bytes(), name


def test_full_offline_chain_gives_the_jax_examples(tmp_path):
    """tests/test_cli_chain.py's chain (L0 preprocess -> PRJ probes ->
    labels -> BM25 mining CLI -> negative merges -> reformulate -> the
    training builder), once with each package's modules, one tokenizer."""
    from haconvdr_tpu.cli.bm25_search import main as jax_bm25
    from haconvdr_tpu.data.topiocqa import build_topiocqa_train_examples as jax_build
    from haconvdr_tpu.mine.prj import convert_gold_to_trec as jax_gold
    from haconvdr_tpu.mine.prj import create_label_rel_turn as jax_probes
    from haconvdr_tpu.preprocess import topiocqa as jax_pt
    from haconvdr_torch.cli.bm25_search import main as torch_bm25
    from haconvdr_torch.config import DataConfig
    from haconvdr_torch.data.topiocqa import build_topiocqa_train_examples as torch_build
    from haconvdr_torch.mine.prj import convert_gold_to_trec as torch_gold
    from haconvdr_torch.mine.prj import create_label_rel_turn as torch_probes
    from haconvdr_torch.preprocess import topiocqa as torch_pt
    from haconvdr_torch.utils.io import read_jsonl_list, write_jsonl
    from haconvdr_torch.utils.testing import HashTokenizer

    qid2passage = {pid: f"Title {pid} content about topic{pid} item{pid}" for pid in range(1, 31)}
    gold = [
        {"conv_id": 1, "turn_id": 1, "question": "what is topic3", "answers": ["a1"],
         "positive_ctxs": [{"passage_id": "3", "title": "T", "text": "content about topic3 item3"}]},
        {"conv_id": 1, "turn_id": 2, "question": "tell me more", "answers": ["a2"],
         "positive_ctxs": [{"passage_id": "7", "title": "T", "text": "content about topic7 item7"}]},
        {"conv_id": 1, "turn_id": 3, "question": "and item12", "answers": ["a3"],
         "positive_ctxs": [{"passage_id": "12", "title": "T", "text": "content item12"}]},
    ]
    combined = [
        {"id": f"1-{t}", "conv_id": 1, "turn_id": t, "query": g["question"],
         "rewrite": g["question"] + " rw", "history_query": [x["question"] for x in gold[:t - 1]],
         "history_rewrite": [x["question"] for x in gold[:t - 1]],
         "history_answer": [x["answers"][0] for x in gold[:t - 1]],
         "last_response": qid2passage[int(gold[t - 2]["positive_ctxs"][0]["passage_id"])]
         if t > 1 else "", "topic": "t", "sub_topic": "s",
         "pos_docs": [qid2passage[int(g["positive_ctxs"][0]["passage_id"])]],
         "pos_docs_id": [int(g["positive_ctxs"][0]["passage_id"])]}
        for t, g in enumerate(gold, start=1)
    ]
    examples, probes = {}, {}
    for name, pt, bm25, make_probes, to_trec, build in (
        ("jax", jax_pt, jax_bm25, jax_probes, jax_gold, jax_build),
        ("torch", torch_pt, torch_bm25, torch_probes, torch_gold, torch_build),
    ):
        d = tmp_path / name
        d.mkdir()
        coll = _collection(d)
        (d / "gold_train.json").write_text(json.dumps(gold))
        pt.gen_train_test_files(str(d / "gold_train.json"), str(d / "gold_train.json"),
                                str(d / "train.json"), str(d / "test.json"),
                                qid2passage=qid2passage, num_passages=30)
        probes[name] = (make_probes(combined), to_trec(make_probes(combined)))
        write_jsonl([{"id": "1-1", "rel_label": []}, {"id": "1-2", "rel_label": [1]},
                     {"id": "1-3", "rel_label": [0, 1]}], str(d / "rel.json"))
        pt.merge_rel_label_info(str(d / "rel.json"), str(d / "train.json"),
                                str(d / "train_rel.json"))
        bm25(["index", f"data.collection_path={coll}", f"bm25.index_dir_path={d / 'idx'}"])
        # as tests/test_cli_chain.py: BM25 queries that match every passage
        queries = [{"sample_id": f"TopiOCQA-Train_1_{t}",
                    "query": f"content about topic{c['pos_docs_id'][0]}",
                    "history_query": c["history_query"], "history_answer": c["history_answer"]}
                   for t, c in enumerate(combined, start=1)]
        write_jsonl(queries, str(d / "queries.json"))
        bm25(["search", f"bm25.index_dir_path={d / 'idx'}",
              f"data.test_file_path={d / 'queries.json'}", "query_type=convqa",
              f"output_trec={d / 'bm25.trec'}", "bm25.top_k=5"])
        pt.merge_bm25_neg_info(str(d / "bm25.trec"), str(d / "train_rel.json"),
                               str(d / "train_negs.json"))
        pt.extract_doc_content_of_bm25_hard_negs_for_train_file(
            "", str(d / "train_negs.json"), str(d / "train_negs.json"), qid2passage=qid2passage)
        pt.reformulate_dataset_info(str(d / "train_negs.json"), str(d / "train_info.json"))
        cfg = DataConfig(max_query_length=12, max_doc_length=16, max_response_length=12,
                         max_concat_length=48, use_PRL=True, is_train=True)
        examples[name] = build(cfg, HashTokenizer(512), str(d / "train_info.json"))
        assert read_jsonl_list(str(d / "train_info.json"))[1]["rel_label"] == [1]
    assert probes["torch"] == probes["jax"]
    for f in ("train.json", "train_info.json", "bm25.trec"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert len(examples["torch"]) == len(examples["jax"]) == 3
    assert examples["torch"][1]["has_pseudo_prepos"] == 1
    for got, want in zip(examples["torch"], examples["jax"]):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    """A g++ that writes half a library and fails: the build raises (no
    numpy fallback), leaves nothing in the build directory (the one output
    g++ was given lay there, not under native/), and the plain twin still
    answers when it is asked for."""
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "g++").write_text(textwrap.dedent("""\
        #!/bin/sh
        while [ "$1" != "-o" ]; do shift; done
        echo "$2" >> "$(dirname "$0")/outputs"
        echo partial > "$2"
        echo "g++: fatal error: out of memory" >&2
        exit 1
    """))
    (fake / "g++").chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(tbm25, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tbm25, "_LIB", None)
    idx = _index(BM25Index, _docs(20))
    with pytest.raises(RuntimeError, match="out of memory"):
        idx.batch_search(["cat"], k=3)
    assert os.listdir(tmp_path / "build") == []
    out = (fake / "outputs").read_text().split()
    assert len(out) == 1 and os.path.dirname(out[0]) == str(tmp_path / "build")
    d, s = idx.batch_search(["cat"], k=3, plain=True)
    assert d.shape == (1, 3)


def test_library_is_built_outside_native_by_an_atomic_replace(tmp_path):
    """Two processes build into one empty directory at once: both load a
    whole library, one file remains under its source-hash name, no
    temporary file is left.  The default directory is build/haconvdr_torch/,
    and no port library lies in native/ (JAX's own build writes
    native/libbm25.so, which other test files may be doing meanwhile)."""
    build = tmp_path / "build"
    code = textwrap.dedent(f"""\
        import sys
        from haconvdr_torch.mine import bm25
        bm25.BUILD_DIR = {str(build)!r}
        idx = bm25.BM25Index()
        idx.add_many([("a", "cat dog"), ("b", "dog")])
        idx.finalize()
        d, s = idx.batch_search(["dog"], k=2)
        assert list(d[0]) == [1, 0], d
        print(bm25.library_path())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=tbm25._ROOT)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = os.listdir(build)
    assert len(names) == 1 and names[0].startswith("libbm25-") and names[0].endswith(".so")
    assert {o.strip() for o, _ in outs} == {str(build / names[0])}
    assert os.path.dirname(tbm25.library_path()) == os.path.join(tbm25._ROOT, "build",
                                                                 "haconvdr_torch")
    native = os.listdir(os.path.join(tbm25._ROOT, "native"))
    assert not [n for n in native if n.startswith("libbm25-")], native
