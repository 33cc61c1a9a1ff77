"""The port's L0 preprocessing copies (haconvdr_torch/preprocess/) against
the JAX package's (tests/test_preprocess.py's synthetic dumps).

Pass condition: each pipeline, run by both packages on the same inputs and
seeds into two directories, writes the same files byte for byte and
returns the same values; the port's outputs also pass
tests/test_preprocess.py's own checks.
"""

import json
import os
import types

import pytest

from haconvdr_tpu.preprocess import collections as jcoll
from haconvdr_tpu.preprocess import qrecc as jpq
from haconvdr_tpu.preprocess import topiocqa as jpt
from haconvdr_torch.preprocess import collections as tcoll
from haconvdr_torch.preprocess import qrecc as tpq
from haconvdr_torch.preprocess import topiocqa as tpt
from haconvdr_torch.utils.io import pstore, read_jsonl_list

PKGS = {
    "jax": types.SimpleNamespace(pt=jpt, pq=jpq, coll=jcoll),
    "torch": types.SimpleNamespace(pt=tpt, pq=tpq, coll=tcoll),
}
QID2PASSAGE = {i: f"passage {i}" for i in range(100)}


def _gold(conv_id, turn_id, question, pid, title="T [SEP] S", text="body"):
    return {
        "conv_id": conv_id, "turn_id": turn_id, "question": question, "answers": ["ans"],
        "positive_ctxs": [{"passage_id": str(pid), "title": title, "text": text}],
    }


def _qrecc_turn(conv, turn, question, rewrite, answer, passages, context):
    return {
        "Conversation_no": conv, "Turn_no": turn, "Question": question,
        "Truth_rewrite": rewrite, "Truth_answer": answer, "Truth_passages": passages,
        "Context": context, "Conversation_source": "quac",
    }


def _inputs(d):
    """Every raw input the pipelines below read, written into ``d``."""
    train = [_gold(1, 1, "q11", 10), _gold(1, 2, "q12", 20), _gold(1, 3, "q13", 25),
             _gold(2, 1, "q21", 30)]
    (d / "gold_train.json").write_text(json.dumps(train))
    (d / "gold_dev.json").write_text(json.dumps([_gold(5, 1, "d11", 40), _gold(5, 2, "d12", 50)]))
    (d / "rel.json").write_text("".join(json.dumps(r) + "\n" for r in (
        {"id": "1-1", "rel_label": []}, {"id": "1-2", "rel_label": [1]},
        {"id": "1-3", "rel_label": [0, 1]}, {"id": "2-1", "rel_label": []})))
    lines = [f"TopiOCQA-Train_1_2 Q0 {pid} {r + 1} {199 - r} 9.9 bm25\n"
             for r, pid in enumerate([20, 7, 8])]
    lines += ["TopiOCQA-Train_1_1 Q0 3 1 199 5.0 bm25\n", "TopiOCQA-Train_1_3 Q0 4 1 199 5.0 bm25\n",
              "TopiOCQA-Train_2_1 Q0 4 1 199 5.0 bm25\n"]
    (d / "bm25.trec").write_text("".join(lines))
    with open(d / "prf_bm25.trec", "w") as f, open(d / "prf_ance.trec", "w") as g:
        for rank in range(1, 101):  # q1: disjoint runs
            f.write(f"q1 Q0 {rank} {rank} {200 - rank} 1.0 bm25\n")
            g.write(f"q1 Q0 {100 + rank} {rank} {200 - rank} 1.0 ance\n")
        for rank in range(1, 101):  # q2: overlapping runs
            f.write(f"q2 Q0 {rank % 40} {rank} {200 - rank} 1.0 bm25\n")
            g.write(f"q2 Q0 {(rank * 7) % 50} {rank} {200 - rank} 1.0 ance\n")
    (d / "prf_queries.json").write_text(
        "".join(json.dumps({"sample_id": q, "query": "x"}) + "\n" for q in ("q1", "q2", "q3")))
    with open(d / "coll.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in range(201):
            f.write(f"{pid}\tbody {pid}\tTi [SEP] Sec {pid}\n")
    raw = [
        {"Question": "q1", "Answer": "a1", "Context": [], "Topic": "T", "Topic_section": "S",
         "Rationale": "", "is_nq": False},
        {"Question": "q2", "Answer": "a2", "Context": ["q1", "a1"], "Topic": "T",
         "Topic_section": "S", "Rationale": "", "is_nq": False},
    ]
    gold = [
        {"conv_id": 1, "turn_id": 1,
         "positive_ctxs": [{"passage_id": "5", "title": "Ti [SEP] Sec", "text": "tx1"}]},
        {"conv_id": 1, "turn_id": 2,
         "positive_ctxs": [{"passage_id": "6", "title": "Ti", "text": "tx2"}]},
    ]
    for name, obj in (("raw.json", raw), ("gold.json", gold),
                      ("rw.json", [{"question": "r1"}, {"question": "r2"}])):
        (d / name).write_text(json.dumps(obj))
    pstore(["r0", "r1", "r2", "r3", "r4", "r5"], str(d / "pid2rawpid.pkl"))
    qtrain = [
        _qrecc_turn(1, 1, "q1", "rw1", "ans1", ["r0"], []),
        _qrecc_turn(1, 2, "q2", "rw2", "ans2", ["r1"], ["q1", "ans1"]),
        _qrecc_turn(1, 3, "q3", "rw3", "ans3", ["r4", "r5"], ["q1", "ans1", "q2", "ans2"]),
    ]
    (d / "qtrain_raw.json").write_text(json.dumps(qtrain))
    (d / "qtest_raw.json").write_text(json.dumps([_qrecc_turn(9, 1, "tq1", "trw1", "tans1", ["r2"], [])]))
    (d / "qrel.json").write_text(json.dumps({"id": "1-2", "rel_label": [1]}) + "\n"
                                 + json.dumps({"id": "1-3", "rel_label": [1, 0]}) + "\n")
    (d / "qbm25.trec").write_text("QReCC-Train_1_2 Q0 3 1 199 3.3 bm25\n"
                                  "QReCC-Train_1_3 Q0 2 1 199 3.3 bm25\n"
                                  "QReCC-Train_1_3 Q0 0 2 198 3.1 bm25\n"
                                  "QReCC-Train_1_1 Q0 2 1 199 3.3 bm25\n")
    for sub, rows in (("commoncrawl", [("c0", "alpha"), ("c1", "beta")]),
                      ("wayback", [("w0", "gamma")])):
        os.makedirs(d / "paragraphs" / sub)
        (d / "paragraphs" / sub / "part0.jsonl").write_text(
            "".join(json.dumps({"id": i, "contents": c}) + "\n" for i, c in rows))
    (d / "coll.jsonl").write_text('{"id": "7", "title": "Ti", "text": "body"}\n'
                                  '\n{"id": "9", "title": "T2", "text": "b2"}\n')


def _topiocqa_train(m, d):
    m.pt.gen_train_test_files(
        str(d / "gold_train.json"), str(d / "gold_dev.json"), str(d / "train.json"),
        str(d / "test.json"), qid2passage=QID2PASSAGE, num_passages=100,
    )
    m.pt.gen_topiocqa_qrel(str(d / "gold_dev.json"), str(d / "qrel.trec"))


def _topiocqa_merges(m, d):
    _topiocqa_train(m, d)
    m.pt.merge_rel_label_info(str(d / "rel.json"), str(d / "train.json"), str(d / "train_rel.json"))
    m.pt.merge_bm25_neg_info(str(d / "bm25.trec"), str(d / "train_rel.json"),
                             str(d / "train_negs.json"))
    m.pt.extract_doc_content_of_bm25_hard_negs_for_train_file(
        "", str(d / "train_negs.json"), str(d / "train_negs.json"), qid2passage=QID2PASSAGE)
    m.pt.reformulate_dataset_info(str(d / "train_negs.json"), str(d / "train_with_info.json"))


def _topiocqa_prf(m, d):
    m.pt.merge_pseudo_relevant_feedback(
        str(d / "prf_queries.json"), str(d / "prf_ance.trec"), str(d / "prf_bm25.trec"),
        str(d / "coll.tsv"), str(d / "prf_out.json"), prf_top=3)
    return m.pt.select_pseudo_relevant_feedback_passage(
        str(d / "prf_bm25.trec"), str(d / "prf_ance.trec"))


def _topiocqa_combine(m, d):
    m.pt.combine_topiocqa_data(str(d / "raw.json"), str(d / "gold.json"), str(d / "rw.json"),
                               str(d / "combined.json"))


def _qrecc(m, d):
    m.pq.gen_qrecc_train_test_files(
        str(d / "qtrain_raw.json"), str(d / "qtest_raw.json"), str(d / "qtrain.json"),
        str(d / "qtest.json"), str(d / "pid2rawpid.pkl"), num_passages=6)
    m.pq.gen_qrecc_qrel(str(d / "qtest_raw.json"), str(d / "qrel.tsv"), str(d / "pid2rawpid.pkl"))
    pid2doc = {i: f"doc {i}" for i in range(6)}
    m.pq.extract_doc_content_of_random_negs_for_train_file(
        "", str(d / "qtrain.json"), str(d / "qtrain_doc.json"), pid2doc=pid2doc)
    m.pq.merge_rel_label_info(str(d / "qrel.json"), str(d / "qtrain_doc.json"),
                              str(d / "qtrain_rel.json"))
    m.pq.merge_bm25_neg_info(str(d / "qbm25.trec"), str(d / "qtrain_rel.json"),
                             str(d / "qtrain_negs.json"))
    m.pq.extract_doc_content_of_bm25_hard_negs_for_train_file(
        "", str(d / "qtrain_negs.json"), str(d / "qtrain_negs.json"), neg_ratio=1,
        pid2doc=pid2doc)
    m.pq.reformulate_dataset_info(str(d / "qtrain_negs.json"), str(d / "qfinal.json"))


def _collections(m, d):
    m.coll.convert_collection_to_jsonl(str(d / "coll.tsv"), str(d / "coll_out.jsonl"))
    n = m.coll.gen_qrecc_passage_collection(
        str(d / "paragraphs"), str(d / "qrecc_coll.tsv"), str(d / "qrecc_pid2rawpid.pkl"))
    return (n, list(m.coll.iter_jsonl_collection(str(d / "coll.jsonl"))),
            list(m.coll.iter_qrecc_collection(str(d / "qrecc_coll.tsv"))),
            m.coll.load_topiocqa_collection(str(d / "coll.tsv")))


PIPELINES = {
    "topiocqa_train_test": _topiocqa_train,
    "topiocqa_merges": _topiocqa_merges,
    "topiocqa_prf": _topiocqa_prf,
    "topiocqa_combine": _topiocqa_combine,
    "qrecc": _qrecc,
    "collections": _collections,
}


def _files(d):
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_writes_the_jax_files(tmp_path, name):
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        _inputs(d)
        before = set(_files(d))
        ret = PIPELINES[name](PKGS[pkg], d)
        out[pkg] = (ret, _files(d))
        assert set(out[pkg][1]) - before, f"{name} wrote nothing"
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1].keys() == out["jax"][1].keys()
    for path, data in out["torch"][1].items():
        assert data == out["jax"][1][path], path


def test_the_ports_outputs_pass_the_jax_tests_checks(tmp_path):
    """tests/test_preprocess.py's assertions, on the port's outputs."""
    m = PKGS["torch"]
    _inputs(tmp_path)
    _topiocqa_merges(m, tmp_path)
    recs = read_jsonl_list(str(tmp_path / "train.json"))
    assert [r["sample_id"] for r in recs][:2] == ["TopiOCQA-Train_1_1", "TopiOCQA-Train_1_2"]
    assert recs[3]["last_response"] == "" and recs[3]["prepos_neg_docs_pids"] == []
    assert recs[1]["last_response"] == "T S body" and recs[1]["prepos_neg_docs_pids"] == [10]
    assert (tmp_path / "qrel.trec").read_text().splitlines() == [
        "TopiOCQA-Dev_5_1 0 40 1", "TopiOCQA-Dev_5_2 0 50 1"]
    recs = read_jsonl_list(str(tmp_path / "train_with_info.json"))
    assert recs[1]["bm25_hard_neg_docs"] == ["passage 7", "passage 8"]
    assert recs[1]["pseudo_prepos_docs_pids"] == [10] and recs[1]["rel_label"] == [1]
    pos, neg = _topiocqa_prf(m, tmp_path)
    assert pos["q1"] == [101, 102, 103] and len(neg["q1"]) == 3
    _topiocqa_combine(m, tmp_path)
    recs = read_jsonl_list(str(tmp_path / "combined.json"))
    assert recs[1]["last_response"] == "Ti Sec tx1" and recs[1]["history_rewrite"] == ["r1"]
    _qrecc(m, tmp_path)
    recs = read_jsonl_list(str(tmp_path / "qtrain.json"))
    assert recs[0]["cur_utt_text"] == "rw1" and recs[1]["ctx_utts_text"] == ["rw1", "ans1"]
    assert (tmp_path / "qrel.tsv").read_text().splitlines() == ["QReCC-Test_9_1\t0\t2\t1"]
    recs = read_jsonl_list(str(tmp_path / "qfinal.json"))
    assert recs[1]["pseudo_prepos_docs"] == ["doc 0"] and recs[1]["bm25_hard_neg_docs"] == ["doc 3"]
    n, jsonl, qrecc, topiocqa = _collections(m, tmp_path)
    assert n == 3 and jsonl == [(7, "Ti[SEP]body"), (9, "T2[SEP]b2")]
    assert qrecc == [(0, "alpha"), (1, "beta"), (2, "gamma")]
    assert topiocqa[3] == "Ti Sec 3 body 3"
    rec = json.loads((tmp_path / "coll_out.jsonl").read_text().splitlines()[0])
    assert rec == {"contents": "Ti Sec 0 body 0", "id": "doc1"}  # the header is row 0
