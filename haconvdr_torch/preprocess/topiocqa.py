"""TopiOCQA L0 preprocessing pipeline (counterpart of
haconvdr_tpu/preprocess/topiocqa.py).

Rebuilds preprocess/preprocess_topicoqa.py: raw gold dumps ->
train/test JSONL -> (PRJ labels, BM25 negatives merged in) ->
``train_with_info.json`` consumed by the training dataset builders, plus
the PRF positive/negative selection.  Pure host-side record plumbing; all
functions take/return file paths like the reference CLIs but accept
injected collection dicts for testability.
"""

from __future__ import annotations

import json
import logging
import random
from typing import Dict, List, Optional, Tuple

from haconvdr_torch.preprocess.collections import load_topiocqa_collection
from haconvdr_torch.utils.io import read_jsonl_list, write_jsonl

logger = logging.getLogger(__name__)

TOPIOCQA_NUM_PASSAGES = 25_700_592  # preprocess/preprocess_topicoqa.py:49


def _passage_of(pos: dict) -> str:
    return pos["title"].rstrip().replace(" [SEP] ", " ") + " " + pos["text"].rstrip()


def gen_topiocqa_qrel(raw_dev_file_path: str, output_qrel_file_path: str) -> None:
    """gold_dev.json -> 'TopiOCQA-Dev_conv_turn 0 pid 1' qrel lines
    (preprocess/preprocess_topicoqa.py:7-22)."""
    with open(raw_dev_file_path) as f:
        data = json.load(f)
    with open(output_qrel_file_path, "w") as f:
        for line in data:
            sample_id = f"TopiOCQA-Dev_{line['conv_id']}_{line['turn_id']}"
            for pos in line["positive_ctxs"]:
                f.write(f"{sample_id} 0 {int(pos['passage_id'])} 1\n")


def _gen_split(
    data: List[dict],
    tag: str,
    out_path: str,
    qid2passage: Dict[int, str],
    rng: random.Random,
    num_passages: int,
) -> None:
    """Shared train/dev record builder
    (preprocess/preprocess_topicoqa.py:42-161): per turn emit cur query,
    last_response (previous turn's first positive), positives, and one
    negative drawn from previous-turn positives (prepos) or at random."""
    last_conv_id = -1
    last_response = ""
    context_pos_docs_pids: set = set()
    records = []
    for line in data:
        sample_id = f"{tag}_{line['conv_id']}_{line['turn_id']}"
        positive_ctxs = line["positive_ctxs"]
        pos_docs = [_passage_of(p) for p in positive_ctxs]
        pos_docs_pids = [int(p["passage_id"]) for p in positive_ctxs]

        if int(line["conv_id"]) != last_conv_id:
            context_pos_docs_pids = set()
            # documented divergence: the reference's DEV loop forgets this
            # reset (preprocess_topicoqa.py:108-118 vs the train loop's
            # :73-76), leaking the previous conversation's last response
            # into the next conversation's first dev turn; we reset in
            # both splits (pinned by tests/test_reference_differential.py)
            last_response = ""

        prepos_neg_docs_pids = list(context_pos_docs_pids - set(pos_docs_pids))
        if prepos_neg_docs_pids:
            neg_pid = rng.choice(prepos_neg_docs_pids)
        else:
            neg_pid = rng.randrange(num_passages)
        records.append(
            {
                "sample_id": sample_id,
                "cur_utt_text": line["question"],
                "last_response": last_response,
                "pos_docs": pos_docs,
                "pos_docs_pids": pos_docs_pids,
                "neg_docs": [qid2passage.get(neg_pid, "")],
                "neg_docs_pids": [neg_pid],
                "prepos_neg_docs_pids": prepos_neg_docs_pids,
            }
        )
        last_response = _passage_of(positive_ctxs[0])
        context_pos_docs_pids |= set(pos_docs_pids)
        last_conv_id = int(line["conv_id"])
    write_jsonl(records, out_path)


def gen_train_test_files(
    raw_train_file_path: str,
    raw_dev_file_path: str,
    output_train_file_path: str,
    output_test_file_path: str,
    collection_file_path: str = "",
    qid2passage: Optional[Dict[int, str]] = None,
    seed: int = 42,
    num_passages: int = TOPIOCQA_NUM_PASSAGES,
) -> None:
    """preprocess/preprocess_topicoqa.py:25-161."""
    if qid2passage is None:
        qid2passage = load_topiocqa_collection(collection_file_path)
    rng = random.Random(seed)
    with open(raw_train_file_path) as f:
        _gen_split(json.load(f), "TopiOCQA-Train", output_train_file_path,
                   qid2passage, rng, num_passages)
    with open(raw_dev_file_path) as f:
        _gen_split(json.load(f), "TopiOCQA-Dev", output_test_file_path,
                   qid2passage, rng, num_passages)


def merge_rel_label_info(rel_file: str, orig_file: str, new_file: str) -> None:
    """Attach PRJ rel_label lists to train/test records; first turns get []
    (preprocess/preprocess_topicoqa.py:163-182).  Alignment is by position
    with an id assertion, as in the reference."""
    rel_labels = read_jsonl_list(rel_file)
    records = read_jsonl_list(orig_file)
    out = []
    for i, rec in enumerate(records):
        sid = rec["sample_id"]
        if "_" in sid:  # 'TopiOCQA-Train_conv_turn' layout
            conv_id, turn_id = sid.split("_")[-2:]
        elif "-" in sid:  # 'conv-turn' layout (records whose sample_id
            # already uses the PRJ-stage id convention — the format the
            # reference's own split('-') checks at :175-180 expect)
            conv_id, turn_id = sid.split("-")[0], sid.split("-")[-1]
        else:
            # neither layout: conv_id == turn_id == sid would slip past
            # the turn_id != "1" gate and mis-merge positionally — fail
            # loudly instead
            raise ValueError(
                f"unrecognized sample_id layout {sid!r}: expected "
                "'Name_conv_turn' or 'conv-turn'"
            )
        if turn_id != "1":
            # positional alignment with a conv/turn sanity check (the
            # reference's string-format check at :175-176 can never match
            # across the two id layouts; the intent is this alignment)
            rel_id = rel_labels[i]["id"]
            assert tuple(rel_id.split("-")[:2]) == (conv_id, turn_id), (
                rec["sample_id"], rel_id,
            )
            rec["rel_label"] = rel_labels[i]["rel_label"]
        else:
            rec["rel_label"] = []
        out.append(rec)
    write_jsonl(out, new_file)


def merge_bm25_neg_info(bm25_run_file: str, orig_file: str, new_file: str) -> None:
    """Attach bm25 run pids (minus gold positives) as hard-negative pid
    lists (preprocess/preprocess_topicoqa.py:184-211)."""
    qid2bm25: Dict[str, List[int]] = {}
    with open(bm25_run_file) as f:
        for line in f:
            parts = line.split()
            qid2bm25.setdefault(parts[0], []).append(int(parts[2]))
    out = []
    for rec in read_jsonl_list(orig_file):
        pos = set(rec["pos_docs_pids"])
        rec["bm25_hard_neg_docs_pids"] = [
            pid for pid in qid2bm25.get(rec["sample_id"], []) if pid not in pos
        ]
        out.append(rec)
    write_jsonl(out, new_file)


def extract_doc_content_of_bm25_hard_negs_for_train_file(
    collection_file_path: str,
    train_inputfile: str,
    train_outputfile_with_doc: str,
    qid2passage: Optional[Dict[int, str]] = None,
) -> None:
    """Materialize the text of every bm25 hard-negative pid
    (preprocess/preprocess_topicoqa.py:214-248)."""
    if qid2passage is None:
        qid2passage = load_topiocqa_collection(collection_file_path)
    out = []
    for rec in read_jsonl_list(train_inputfile):
        pos = set(rec["pos_docs_pids"])
        rec["bm25_hard_neg_docs"] = [
            qid2passage[pid]
            for pid in rec["bm25_hard_neg_docs_pids"]
            if pid in qid2passage and pid not in pos
        ]
        out.append(rec)
    write_jsonl(out, train_outputfile_with_doc)


def reformulate_dataset_info(input_file: str, output_file: str) -> None:
    """Split previous-turn positives into pseudo-positives (rel_label 1)
    vs prepos hard negatives (rel_label 0) and assemble the final
    train_with_info layout (preprocess/preprocess_topicoqa.py:266-313).

    Indexing note (documented divergence): the reference walks
    ``data[i - idx]`` for label idx, which reads the WRONG records —
    newest-first offset by one, including the CURRENT turn at idx=0.
    Label k refers to history turn k+1, stored at record
    ``i - (len(labels) - k)``; we use that correct indexing (the same
    convention the train dataset reader applies, src/data.py:284-290).
    The divergence is pinned by tests/test_reference_differential.py.
    """
    records = read_jsonl_list(input_file)
    out = []
    for i, rec in enumerate(records):
        rel_label = rec["rel_label"]
        pseudo_docs, pseudo_pids, pn_docs, pn_pids = [], [], [], []
        for idx, label in enumerate(rel_label):
            src = records[i - (len(rel_label) - idx)]
            if label == 1:
                pseudo_docs.extend(src["pos_docs"])
                pseudo_pids.extend(src["pos_docs_pids"])
            else:
                pn_docs.extend(src["pos_docs"])
                pn_pids.extend(src["pos_docs_pids"])
        out.append(
            {
                "sample_id": rec["sample_id"],
                "cur_utt_text": rec["cur_utt_text"],
                "last_response": rec["last_response"],
                "pos_docs": rec["pos_docs"],
                "pos_docs_pids": rec["pos_docs_pids"],
                "bm25_hard_neg_docs": rec["bm25_hard_neg_docs"],
                "bm25_hard_neg_docs_pids": rec["bm25_hard_neg_docs_pids"],
                "pseudo_prepos_docs": pseudo_docs,
                "pseudo_prepos_docs_pids": pseudo_pids,
                "prepos_neg_docs": pn_docs,
                "prepos_neg_docs_pids": pn_pids,
                "rel_label": rel_label,
            }
        )
    write_jsonl(out, output_file)


# ---------------------------------------------------------------------------
# PRF (pseudo relevance feedback)
# ---------------------------------------------------------------------------

def select_pseudo_relevant_feedback_passage(
    bm25_trec_file: str, ance_trec_file: str, neg_ratio: int = 3
) -> Tuple[Dict[str, List[int]], Dict[str, List[int]]]:
    """BM25/ANCE run-agreement PRF selection
    (preprocess/preprocess_topicoqa.py:315-375): positives = dense top
    docs when the runs are disjoint, else best co-occurring docs by summed
    rank; negatives = rank-disagreement docs."""
    qid2pos: Dict[str, List[int]] = {}
    qid2neg: Dict[str, List[int]] = {}
    with open(bm25_trec_file) as f, open(ance_trec_file) as g:
        bm25_data, ance_data = f.readlines(), g.readlines()
    assert len(bm25_data) == len(ance_data)

    bm25_list: List[int] = []
    ance_list: List[int] = []
    for idx in range(len(bm25_data)):
        b_parts, a_parts = bm25_data[idx].split(), ance_data[idx].split()
        assert b_parts[0] == a_parts[0] and b_parts[3] == a_parts[3]
        qid = b_parts[0]
        bm25_list.append(int(b_parts[2]))
        ance_list.append(int(a_parts[2]))
        if int(a_parts[3]) != 100:
            continue
        pos: List[int] = []
        neg: List[int] = []
        bset, aset = set(bm25_list), set(ance_list)
        if not (bset & aset):
            pos = ance_list[:neg_ratio]
        for i in range(10):
            if bm25_list[i] not in aset and bm25_list[i] not in pos:
                neg.append(bm25_list[i])
            if ance_list[i] not in bset and ance_list[i] not in pos:
                neg.append(ance_list[i])
        neg = neg[:neg_ratio]
        # co-occurrence rank sum over the full lists
        cooc: Dict[int, int] = {}
        a_rank = {p: r for r, p in enumerate(ance_list)}
        b_rank = {p: r for r, p in enumerate(bm25_list)}
        for r, p in enumerate(bm25_list):
            if p in a_rank:
                cooc[p] = min(cooc.get(p, 1 << 30), r + a_rank[p])
        for r, p in enumerate(ance_list):
            if p in b_rank:
                cooc[p] = min(cooc.get(p, 1 << 30), r + b_rank[p])
        ranked = sorted(cooc.items(), key=lambda kv: kv[1])
        for p, _ in ranked:
            if len(pos) >= neg_ratio:
                break
            pos.append(p)
        for p, _ in reversed(ranked):
            if len(neg) >= neg_ratio:
                break
            if p not in pos:
                neg.append(p)
        qid2pos[qid], qid2neg[qid] = pos, neg
        bm25_list, ance_list = [], []
    return qid2pos, qid2neg


def merge_pseudo_relevant_feedback(
    query_file: str,
    ance_trec_file: str,
    bm25_trec_file: str,
    collection_file: str,
    output_file: str,
    qid2passage: Optional[Dict[int, str]] = None,
    prf_top: int = 3,
) -> None:
    """Attach PRF_pos_docs (dense top-3) and the selected PRF pos/neg sets
    (preprocess/preprocess_topicoqa.py:377-422)."""
    if qid2passage is None:
        qid2passage = load_topiocqa_collection(collection_file)
    qid2prf: Dict[str, List[int]] = {}
    with open(ance_trec_file) as f:
        for line in f:
            parts = line.split()
            if int(parts[3]) > prf_top:
                continue
            qid2prf.setdefault(parts[0], []).append(int(parts[2]))
    qid2pos, qid2neg = select_pseudo_relevant_feedback_passage(
        bm25_trec_file, ance_trec_file
    )
    out = []
    for rec in read_jsonl_list(query_file):
        qid = rec["sample_id"]
        prf_pids = qid2prf.get(qid, [])
        rec["PRF_pos_docs"] = [qid2passage[p] for p in prf_pids]
        rec["PRF_pos_docs_pids"] = prf_pids
        rec["selected_PRF_pos_docs"] = [qid2passage[p] for p in qid2pos.get(qid, [])]
        rec["selected_PRF_pos_docs_pids"] = qid2pos.get(qid, [])
        rec["selected_PRF_neg_docs"] = [qid2passage[p] for p in qid2neg.get(qid, [])]
        rec["selected_PRF_neg_docs_pids"] = qid2neg.get(qid, [])
        out.append(rec)
    write_jsonl(out, output_file)


# ---------------------------------------------------------------------------
# Combined data for PRJ probe generation (train_new/dev_new layout)
# ---------------------------------------------------------------------------

def combine_topiocqa_data(
    raw_file: str,
    gold_file: str,
    rewrite_file: str,
    output_file: str,
    is_train: bool = True,
) -> None:
    """Join the raw TopiOCQA dump (Question/Answer/Context/Topic), the
    gold-IR dump (positive_ctxs), and the rewrite dump into the
    train_new/dev_new records PRJ probing consumes
    (preprocess/PRJ_topiocqa.py:83-236).  Random-negative sampling of the
    train variant is dropped here — negatives come from the L0/L2 passes.
    """
    with open(raw_file) as f:
        raw = json.load(f)
    with open(gold_file) as f:
        gold = json.load(f)
    with open(rewrite_file) as f:
        rewrites = json.load(f)
    assert len(raw) == len(gold) == len(rewrites)

    out = []
    history_rewrite: List[str] = []
    last_response = ""
    for i in range(len(raw)):
        conv_id = gold[i]["conv_id"]
        turn_id = gold[i]["turn_id"]
        if int(turn_id) == 1:
            history_rewrite = []
            last_response = ""
        elif i > 0:
            history_rewrite.append(rewrites[i - 1]["question"])
            prev = gold[i - 1]["positive_ctxs"][0]
            last_response = (
                " ".join(prev["title"].split(" [SEP] ")) + " " + prev["text"]
            )
        history_query, history_answer = [], []
        for idx, key in enumerate(raw[i]["Context"]):
            (history_query if idx % 2 == 0 else history_answer).append(key)
        pos = gold[i]["positive_ctxs"][0]
        out.append(
            {
                "id": f"{conv_id}-{turn_id}",
                "conv_id": conv_id,
                "turn_id": turn_id,
                "is_nq": raw[i].get("is_nq"),
                "query": raw[i]["Question"],
                "rewrite": rewrites[i]["question"],
                "answer": raw[i]["Answer"],
                "history_query": history_query,
                "history_rewrite": list(history_rewrite),
                "history_answer": history_answer,
                "last_response": last_response,
                "topic": raw[i]["Topic"],
                "sub_topic": raw[i]["Topic_section"],
                "pos_docs": [" ".join(pos["title"].split(" [SEP] ")) + " " + pos["text"]],
                "pos_docs_id": [int(pos["passage_id"])],
            }
        )
    write_jsonl(out, output_file)
