"""The port's own copies of the framework-free evaluation layers
(haconvdr_torch/eval, data/topiocqa, qrecc, cast, prj, mine/prj) against
the JAX package's modules on the same inputs: fabricated runs, qrels and
conversation records, one shared tokenizer.  Every result must be equal
(the same Python arithmetic on both sides); run files byte for byte."""

import json
import random

import numpy as np
import pytest

import haconvdr_torch.data.cast as t_cast
import haconvdr_torch.data.prj as t_prj
import haconvdr_torch.data.qrecc as t_qrecc
import haconvdr_torch.data.topiocqa as t_topiocqa
import haconvdr_torch.eval.analysis as t_analysis
import haconvdr_torch.eval.metrics as t_metrics
import haconvdr_torch.eval.trec as t_trec
import haconvdr_torch.mine.prj as t_mine
import haconvdr_tpu.data.cast as j_cast
import haconvdr_tpu.data.prj as j_prj
import haconvdr_tpu.data.qrecc as j_qrecc
import haconvdr_tpu.data.topiocqa as j_topiocqa
import haconvdr_tpu.eval.analysis as j_analysis
import haconvdr_tpu.eval.metrics as j_metrics
import haconvdr_tpu.eval.trec as j_trec
import haconvdr_tpu.mine.prj as j_mine
from haconvdr_torch.config import DataConfig as TorchDataConfig
from haconvdr_torch.utils.testing import HashTokenizer
from haconvdr_tpu.config import DataConfig as JaxDataConfig

WORDS = [f"w{i}" for i in range(60)]
TOK = HashTokenizer(512)


def _text(r, lo, hi):
    return " ".join(r.choice(WORDS) for _ in range(r.randint(lo, hi)))


# ---------------------------------------------------------------------------
# metrics, run files, analysis
# ---------------------------------------------------------------------------

def _fabricated_eval(seed):
    """A run with tied scores and docs outside the qrels, graded qrels
    (grades 0-3) over most of the run's queries and some of its own."""
    r = random.Random(seed)
    run, qrels = {}, {}
    for q in range(12):
        qid = f"C{q // 4}_{q % 4 + 1}"
        docs = r.sample(range(40), 25)
        run[qid] = {str(d): float(r.randint(0, 8)) for d in docs}  # ties
        if q % 5 != 4:
            qrels[qid] = {str(d): r.randint(0, 3) for d in r.sample(range(40), 3)}
    qrels["C9_1"] = {"1": 1}  # a qrel query absent from the run
    binary = {q: {d: int(g >= 2) for d, g in v.items()} for q, v in qrels.items()}
    return run, binary, qrels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal(seed):
    run, binary, graded = _fabricated_eval(seed)
    assert t_metrics.evaluate_run(run, binary, graded) == j_metrics.evaluate_run(
        run, binary, graded)
    assert t_metrics.evaluate_run(run, binary, graded, (1, 7), 5) == j_metrics.evaluate_run(
        run, binary, graded, (1, 7), 5)
    assert t_metrics.trec_metrics(run, binary, graded) == j_metrics.trec_metrics(
        run, binary, graded)


def _ranked_arrays(seed, Q=6, K=12):
    rng = np.random.RandomState(seed)
    scores = np.sort(rng.randn(Q, K).astype(np.float32), axis=1)[:, ::-1].copy()
    offsets = rng.randint(0, 20, (Q, K))  # duplicate pids after the map
    offsets[0, -3:] = -1  # unfilled slots
    offset2pid = [int(x) for x in rng.permutation(20) * 3 + 7]
    qids = [f"Q_{i // 2}_{i}" for i in range(Q)]
    qids[3] = qids[2]  # a repeated query id keeps its first occurrence
    return qids, scores, offsets, offset2pid


@pytest.mark.parametrize("use_map", [True, False])
def test_dedup_and_run_file_byte_for_byte(tmp_path, use_map):
    qids, scores, offsets, offset2pid = _ranked_arrays(3)
    o2p = offset2pid if use_map else None
    ranked = t_trec.dedup_ranked_candidates(qids, scores, offsets, o2p, 10)
    assert ranked == j_trec.dedup_ranked_candidates(qids, scores, offsets, o2p, 10)
    t_trec.write_run(ranked, str(tmp_path / "t.trec"))
    j_trec.write_run(ranked, str(tmp_path / "j.trec"))
    assert (tmp_path / "t.trec").read_bytes() == (tmp_path / "j.trec").read_bytes()
    t_trec.write_run(ranked, str(tmp_path / "t2.trec"), tag="x")
    j_trec.write_run(ranked, str(tmp_path / "j2.trec"), tag="x")
    assert (tmp_path / "t2.trec").read_bytes() == (tmp_path / "j2.trec").read_bytes()
    assert t_trec.read_run(str(tmp_path / "t.trec")) == j_trec.read_run(str(tmp_path / "t.trec"))


@pytest.mark.parametrize("rel_threshold", [1, 2])
def test_qrels_and_trec_evaluation_equal(tmp_path, rel_threshold):
    qids, scores, offsets, offset2pid = _ranked_arrays(5)
    qrel = tmp_path / "qrel.tsv"
    r = random.Random(rel_threshold)
    with open(qrel, "w") as f:
        for q in qids:
            for pid in r.sample(offset2pid, 3):
                f.write(f"{q}\t0\t{pid}\t{r.randint(0, 2)}\n")
        f.write("short line\n")
    assert t_trec.read_qrels(str(qrel), rel_threshold) == j_trec.read_qrels(
        str(qrel), rel_threshold)
    got = t_trec.output_test_res(qids, scores, offsets, offset2pid, 10, str(tmp_path / "t.trec"),
                                 str(qrel), rel_threshold)
    want = j_trec.output_test_res(qids, scores, offsets, offset2pid, 10,
                                  str(tmp_path / "j.trec"), str(qrel), rel_threshold)
    assert got == want and got
    assert (tmp_path / "t.trec").read_bytes() == (tmp_path / "j.trec").read_bytes()
    assert t_trec.print_trec_res(str(tmp_path / "t.trec"), str(qrel), rel_threshold) == want


def test_print_res_and_metric_by_turn_equal():
    r = random.Random(4)
    gold, result, per_q = [], [], {}
    for i in range(30):
        conv, turn = i // 6, i % 6 + 1
        gold.append({"conv_id": conv, "turn_id": turn,
                     "positive_ctxs": [{"passage_id": r.randint(0, 50)}]})
        result.append({"conv_id": str(conv), "turn_id": str(turn),
                       "ctxs": [{"doc_id": d} for d in r.sample(range(50), 30)]})
        per_q[f"T_{conv}_{turn}" if i % 2 else f"{conv}-{turn}"] = r.random()
    per_q["no_turn_here"] = 1.0
    assert t_analysis.print_res(result, gold) == j_analysis.print_res(result, gold)
    assert t_analysis.metric_by_turn(per_q) == j_analysis.metric_by_turn(per_q)
    assert t_analysis.metric_by_turn(per_q, 3) == j_analysis.metric_by_turn(per_q, 3)


# ---------------------------------------------------------------------------
# dataset builders
# ---------------------------------------------------------------------------

def _topiocqa_records(seed, n_conv=3, turns=4):
    r = random.Random(seed)
    recs = []
    for c in range(n_conv):
        history = []
        for t in range(turns):
            q = _text(r, 2, 6)
            rec = {
                "sample_id": f"topiocqa_{c}_{t + 1}",
                "cur_utt_text": " [SEP] ".join(history + [q]),
                "last_response": _text(r, 3, 12) if t else "",
                "pos_docs": [_text(r, 8, 30)],
                "PRF_pos_docs": [_text(r, 5, 20) for _ in range(3)],
                "pos_docs_pids": [r.randint(0, 100)],
                "rel_label": [r.randint(0, 1) for _ in range(t)],
                "bm25_hard_neg_docs": [_text(r, 8, 20) for _ in range(2)],
                "pseudo_prepos_docs": [_text(r, 8, 20) for _ in range(r.randint(0, 2))],
                "prepos_neg_docs": [_text(r, 8, 20) for _ in range(r.randint(0, 2))],
            }
            recs.append(rec)
            history += [q, _text(r, 2, 8)] if t % 2 else []
    return recs


def _qrecc_records(seed, n_conv=3, turns=4):
    r = random.Random(seed)
    recs = []
    for c in range(n_conv):
        ctx = []
        for t in range(turns):
            q, a = _text(r, 2, 6), _text(r, 0, 8)
            recs.append({
                "sample_id": f"QReCC-Test_{c}_{t + 1}",
                "cur_utt_text": q,
                "cur_response_text": a,
                "ctx_utts_text": list(ctx),
                "pos_docs_text": [] if (c + t) % 5 == 3 else [_text(r, 8, 30)],
                "rel_label": [r.randint(0, 1) for _ in range(t)],
                "bm25_hard_neg_docs": [_text(r, 8, 20) for _ in range(3)],
                "pseudo_prepos_docs": [_text(r, 8, 20) for _ in range(r.randint(0, 2))],
                "prepos_neg_docs": [_text(r, 8, 20) for _ in range(r.randint(0, 2))],
            })
            ctx += [q, a]
    return recs


def _cast_records(seed):
    r = random.Random(seed)
    recs = []
    for topic in (79, 81):
        inputs = []
        for t in range(4):
            inputs.append(_text(r, 2, 6))
            recs.append({
                "id": f"{topic}_{t + 1}", "topic_number": topic, "query_number": t + 1,
                "input": list(inputs),
                "manual_response": [_text(r, 5, 15) for _ in range(r.randint(0, 2))],
            })
    return recs


def _probe_records(seed):
    r = random.Random(seed)
    return [
        {"id": f"{c}-{t}-{p}", "conv_id": c, "turn_id": t, "query": _text(r, 2, 6),
         "query_pair": "" if p == 0 else _text(r, 2, 6),
         "last_response": _text(r, 0, 10), "history_answer": [_text(r, 1, 6)] * (t - 1)}
        for c in range(3) for t in range(2, 4) for p in range(t)
    ]


def _write(tmp_path, name, records):
    path = tmp_path / name
    path.write_text("".join(json.dumps(rec) + "\n" for rec in records))
    return str(path)


_LENGTHS = dict(max_query_length=8, max_doc_length=12, max_response_length=6,
                max_concat_length=40)

# (name, torch builder, JAX builder, records, extra keyword arguments,
# whether it reads use_PRL / is_PRF / is_train)
_BUILDERS = [
    ("topiocqa test", t_topiocqa.build_topiocqa_test_examples,
     j_topiocqa.build_topiocqa_test_examples, _topiocqa_records, {}, True),
    ("topiocqa train", t_topiocqa.build_topiocqa_train_examples,
     j_topiocqa.build_topiocqa_train_examples, _topiocqa_records, {}, True),
    ("topiocqa train expanded", t_topiocqa.build_topiocqa_train_examples_expanded,
     j_topiocqa.build_topiocqa_train_examples_expanded, _topiocqa_records, {}, True),
    ("qrecc", t_qrecc.build_qrecc_examples, j_qrecc.build_qrecc_examples, _qrecc_records, {},
     True),
    ("qrecc no prepos", t_qrecc.build_qrecc_examples, j_qrecc.build_qrecc_examples,
     _qrecc_records, {"with_prepos": False}, True),
    ("qrecc multineg", t_qrecc.build_qrecc_multineg_examples,
     j_qrecc.build_qrecc_multineg_examples, _qrecc_records, {"num_negs": 2}, True),
    ("cast", t_cast.build_cast_test_examples, j_cast.build_cast_test_examples,
     _cast_records, {}, False),
    ("prj probes", t_prj.build_prj_probe_examples, j_prj.build_prj_probe_examples,
     _probe_records, {}, False),
    ("prj probes with response and answer", t_prj.build_prj_probe_examples,
     j_prj.build_prj_probe_examples, _probe_records,
     {"use_last_response": True, "use_answer": True}, False),
    ("prj probes, a sample", t_prj.build_prj_probe_examples, j_prj.build_prj_probe_examples,
     _probe_records, {"use_data_percent": 0.5, "seed": 3}, False),
]
_FLAGS = [dict(use_PRL=prl, is_PRF=prf, is_train=train)
          for prl, prf in ((False, False), (True, False), (True, True), (False, True))
          for train in (False, True)]
_CASES = [(b[:5], flags) for b in _BUILDERS for flags in (_FLAGS if b[5] else _FLAGS[:1])]


@pytest.mark.parametrize(
    "builder, flags", _CASES,
    ids=[f"{b[0]}-PRL{int(f['use_PRL'])}-PRF{int(f['is_PRF'])}-train{int(f['is_train'])}"
         for b, f in _CASES],
)
def test_builders_equal(tmp_path, builder, flags):
    name, ours, theirs, records, kw = builder
    path = _write(tmp_path, "records.json", records(len(name)))
    flags = dict(flags, PRF_top=2, **_LENGTHS)
    got = ours(TorchDataConfig(**flags), TOK, path, **kw)
    want = theirs(JaxDataConfig(**flags), TOK, path, **kw)
    assert got and got == want


# ---------------------------------------------------------------------------
# PRJ mining
# ---------------------------------------------------------------------------

def _conv_records(seed):
    r = random.Random(seed)
    recs = []
    for c in (3, 4):
        hist = []
        for t in range(1, 5):
            q = _text(r, 2, 6)
            recs.append({
                "conv_id": c, "turn_id": t, "query": q, "history_query": list(hist),
                "history_rewrite": [h.upper() for h in hist], "history_answer": ["a"] * len(hist),
                "pos_docs_id": [r.randint(0, 99)], "topic": r.choice("ab"),
                "sub_topic": r.choice("xyz"), "last_response": "r", "rewrite": q + "?",
            })
            hist.append(q)
    return recs


def _qrecc_probe_source(seed):
    r = random.Random(seed)
    return [{"sample_id": f"{c}-{t}", "query": _text(r, 2, 5),
             "context_queries": [_text(r, 2, 5) for _ in range(t - 1)],
             "pos_docs": [] if t == 3 else [r.randint(0, 9)], "last_response": "x"}
            for c in (1, 2) for t in range(1, 5)]


@pytest.mark.parametrize("fn, source, kw", [
    ("create_label_rel_turn", _conv_records, {}),
    ("create_label_rel_turn", _qrecc_probe_source, {"dataset": "qrecc"}),
    ("create_label_rel_token", _conv_records, {}),
    ("create_topic_rel_turn", _conv_records, {}),
    ("create_topic_rel_turn", _conv_records, {"mode": "sub_topic"}),
])
def test_probe_generation_equal(fn, source, kw):
    recs = source(9)
    got = getattr(t_mine, fn)(recs, **kw)
    assert got and got == getattr(j_mine, fn)(recs, **kw)
    if fn == "create_label_rel_turn":
        assert t_mine.convert_gold_to_trec(got) == j_mine.convert_gold_to_trec(got)


@pytest.mark.parametrize("qrel_filter", [False, True])
def test_improve_judge_and_labels_equal(qrel_filter):
    probes = t_mine.create_label_rel_turn(_conv_records(5))
    r = random.Random(6)
    mrr = {p["id"]: r.choice([0.0, 0.25, 0.5, 1.0]) for p in probes if r.random() < 0.9}
    qrel_ids = {"3-1"} if qrel_filter else None
    rel = t_mine.improve_judge(probes, mrr, qrel_ids=qrel_ids)
    assert rel == j_mine.improve_judge(probes, mrr, qrel_ids=qrel_ids)
    assert t_mine.judge_stats(rel) == j_mine.judge_stats(rel)
    assert t_mine.rel_label_records(rel) == j_mine.rel_label_records(rel)
    labels = [rec for rec in t_mine.rel_label_records(rel) if rec["rel_label"]]
    queries = [rec for rec in _conv_records(5) if f"{rec['conv_id']}-{rec['turn_id']}" in rel
               and rel[f"{rec['conv_id']}-{rec['turn_id']}"]]
    assert t_mine.create_prj_triples(labels, queries) == j_mine.create_prj_triples(labels, queries)
