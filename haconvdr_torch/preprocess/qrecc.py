"""QReCC L0 preprocessing pipeline (counterpart of
haconvdr_tpu/preprocess/qrecc.py).

Rebuilds preprocess/preprocess_qrecc.py: scai-qrecc21 dumps + paragraph
collection -> train/test JSONL (with the CONQRR first-turn Truth_rewrite
substitution), qrels, random/prepos negatives, doc-content extraction, PRJ
label + bm25 negative merges, and the final ``train_with_info_new.json``
layout.  The collection builder itself lives in
preprocess/collections.py (gen_qrecc_passage_collection).
"""

from __future__ import annotations

import json
import logging
import random
from typing import Dict, List, Optional

from haconvdr_torch.preprocess.collections import iter_qrecc_collection
from haconvdr_torch.utils.io import pload, read_jsonl_list, write_jsonl

logger = logging.getLogger(__name__)

QRECC_NUM_PASSAGES = 54_573_064  # preprocess/preprocess_qrecc.py:109


def gen_qrecc_qrel(
    input_test_file: str, output_qrel_file: str, pid2rawpid_path: str
) -> None:
    """Truth_passages raw ids -> dense pids, tab-separated qrel
    (preprocess/preprocess_qrecc.py:63-84)."""
    with open(input_test_file) as f:
        data = json.load(f)
    pid2rawpid = pload(pid2rawpid_path)
    rawpid2pid = {rawpid: pid for pid, rawpid in enumerate(pid2rawpid)}
    with open(output_qrel_file, "w") as f:
        for line in data:
            sample_id = f"QReCC-Test_{line['Conversation_no']}_{line['Turn_no']}"
            for rawpid in line["Truth_passages"]:
                f.write(f"{sample_id}\t0\t{rawpid2pid[rawpid]}\t1\n")


def gen_qrecc_train_test_files(
    train_inputfile: str,
    test_inputfile: str,
    train_outputfile: str,
    test_outputfile: str,
    pid2rawpid_path: str,
    max_random_neg_ratio: int = 5,
    seed: int = 42,
    num_passages: int = QRECC_NUM_PASSAGES,
) -> None:
    """preprocess/preprocess_qrecc.py:87-177.

    Notable semantics kept: the FIRST turn's query is replaced by its
    Truth_rewrite (CONQRR convention, ":124"); context queries are the
    (possibly substituted) previous cur_utt_texts, context answers the raw
    ones; train records get random negatives (excluding positives) and
    previous-turn-positive (prepos) negative pid sets.
    """
    rng = random.Random(seed)
    pid2rawpid = pload(pid2rawpid_path)
    rawpid2pid = {rawpid: pid for pid, rawpid in enumerate(pid2rawpid)}
    sid2utt: Dict[str, str] = {}
    sid2pospid: Dict[str, List[int]] = {}

    for outputfile, inputfile, tag in (
        (train_outputfile, train_inputfile, "QReCC-Train"),
        (test_outputfile, test_inputfile, "QReCC-Test"),
    ):
        with open(inputfile) as f:
            data = json.load(f)
        records = []
        for line in data:
            sample_id = f"{tag}_{line['Conversation_no']}_{line['Turn_no']}"
            cur_utt_text = (
                line["Question"] if int(line["Turn_no"]) != 1 else line["Truth_rewrite"]
            )
            sid2utt[sample_id] = cur_utt_text

            ctx_utts_text = []
            for i in range(len(line["Context"])):
                if i % 2 == 0:
                    ctx_utts_text.append(
                        sid2utt[f"{tag}_{line['Conversation_no']}_{i // 2 + 1}"]
                    )
                else:
                    ctx_utts_text.append(line["Context"][i])

            pos_docs_pids = [rawpid2pid[r] for r in line["Truth_passages"]]
            sid2pospid[sample_id] = pos_docs_pids
            record = {
                "sample_id": sample_id,
                "source": line.get("Conversation_source"),
                "cur_utt_text": cur_utt_text,
                "oracle_utt_text": line["Truth_rewrite"],
                "cur_response_text": line["Truth_answer"],
                "ctx_utts_text": ctx_utts_text,
                "pos_docs_pids": pos_docs_pids,
            }
            if tag == "QReCC-Train":
                random_negs: set = set()
                want = min(
                    max_random_neg_ratio,
                    max(0, num_passages - len(set(pos_docs_pids))),
                )
                while len(random_negs) < want:
                    neg = rng.randint(0, num_passages - 1)
                    if neg not in pos_docs_pids:
                        random_negs.add(neg)
                record["random_neg_docs_pids"] = list(random_negs)
                prepos: set = set()
                for turn_id in range(1, int(line["Turn_no"])):
                    prepos |= set(
                        sid2pospid[f"{tag}_{line['Conversation_no']}_{turn_id}"]
                    )
                record["prepos_neg_docs_pids"] = list(prepos - set(pos_docs_pids))
            records.append(record)
        write_jsonl(records, outputfile)
    logger.info("QReCC train/test first-stage files written")


def extract_doc_content_of_random_negs_for_train_file(
    qrecc_collection_path: str,
    train_inputfile: str,
    train_outputfile_with_doc: str,
    random_neg_ratio: int = 1,
    pid2doc: Optional[Dict[int, str]] = None,
) -> None:
    """Materialize positive + random-negative passage text
    (preprocess/preprocess_qrecc.py:181-240).  Only needed pids are kept
    in memory."""
    records = read_jsonl_list(train_inputfile)
    needed = set()
    for rec in records:
        needed |= set(rec["pos_docs_pids"])
        needed |= set(rec.get("random_neg_docs_pids", [])[:random_neg_ratio])
    if pid2doc is None:
        pid2doc = {
            pid: doc
            for pid, doc in iter_qrecc_collection(qrecc_collection_path)
            if pid in needed
        }
    out = []
    for rec in records:
        pos_docs_text = [
            pid2doc[p] for p in rec["pos_docs_pids"] if p in pid2doc and pid2doc[p]
        ]
        rec["pos_docs_text"] = pos_docs_text
        if pos_docs_text:
            rec["random_neg_docs_text"] = [
                pid2doc[p]
                for p in rec.get("random_neg_docs_pids", [])[:random_neg_ratio]
                if p in pid2doc
            ]
        out.append(rec)
    write_jsonl(out, train_outputfile_with_doc)


def merge_rel_label_info(rel_file: str, orig_file: str, new_file: str) -> None:
    """Attach PRJ labels, tolerating turns the PRJ pass skipped (empty
    positives): unmatched turns get all-zero labels
    (preprocess/preprocess_qrecc.py:245-283)."""
    rel_labels = read_jsonl_list(rel_file)
    out = []
    rel_idx = 0
    for rec in read_jsonl_list(orig_file):
        conv_id, turn_id = rec["sample_id"].split("_")[-2:]
        if rel_idx < len(rel_labels):
            rel_rec = rel_labels[rel_idx]
            rel_conv, rel_turn = rel_rec["id"].split("-")[:2]
        else:
            rel_rec, rel_conv, rel_turn = None, None, None
        if rel_rec is None or (conv_id, turn_id) != (rel_conv, rel_turn):
            rec["rel_label"] = [] if turn_id == "1" else [0] * (int(turn_id) - 1)
        else:
            rec["rel_label"] = [] if turn_id == "1" else rel_rec["rel_label"]
            rel_idx += 1
        out.append(rec)
    write_jsonl(out, new_file)


def merge_bm25_neg_info(bm25_run_file: str, orig_file: str, new_file: str) -> None:
    """Identical logic to the topiocqa variant
    (preprocess/preprocess_qrecc.py:285-311)."""
    from haconvdr_torch.preprocess.topiocqa import merge_bm25_neg_info as _m

    _m(bm25_run_file, orig_file, new_file)


def extract_doc_content_of_bm25_hard_negs_for_train_file(
    qrecc_collection_path: str,
    train_inputfile: str,
    train_outputfile_with_doc: str,
    neg_ratio: int = 3,
    pid2doc: Optional[Dict[int, str]] = None,
    seed: int = 42,
) -> None:
    """Sample ``neg_ratio`` of the top-20 bm25 hard negatives and attach
    their text (preprocess/preprocess_qrecc.py:313-359)."""
    rng = random.Random(seed)
    records = read_jsonl_list(train_inputfile)
    if pid2doc is None:
        pid2doc = {
            pid: doc for pid, doc in iter_qrecc_collection(qrecc_collection_path) if doc
        }
    out = []
    for rec in records:
        pool = rec["bm25_hard_neg_docs_pids"][:20]
        k = min(neg_ratio, len(pool))
        rec["bm25_hard_neg_docs"] = [pid2doc[p] for p in rng.sample(pool, k) if p in pid2doc]
        out.append(rec)
    write_jsonl(out, train_outputfile_with_doc)


def reformulate_dataset_info(input_file: str, output_file: str) -> None:
    """Final train_with_info_new layout with pseudo-prepos / prepos-neg
    docs split by rel_label (preprocess/preprocess_qrecc.py:361-411);
    history indexing fixed as in the topiocqa variant."""
    records = read_jsonl_list(input_file)
    out = []
    for i, rec in enumerate(records):
        rel_label = rec["rel_label"]
        pseudo_docs, pseudo_pids, pn_docs, pn_pids = [], [], [], []
        for idx, label in enumerate(rel_label):
            src = records[i - (len(rel_label) - idx)]
            if label == 1:
                pseudo_docs.extend(src["pos_docs_text"])
                pseudo_pids.extend(src["pos_docs_pids"])
            else:
                pn_docs.extend(src["pos_docs_text"])
                pn_pids.extend(src["pos_docs_pids"])
        out.append(
            {
                "sample_id": rec["sample_id"],
                "cur_utt_text": rec["cur_utt_text"],
                "cur_response_text": rec["cur_response_text"],
                "ctx_utts_text": rec["ctx_utts_text"],
                "pos_docs_text": rec["pos_docs_text"],
                "pos_docs_pids": rec["pos_docs_pids"],
                "bm25_hard_neg_docs": rec.get("bm25_hard_neg_docs", [])
                if rec["pos_docs_text"]
                else [],
                "bm25_hard_neg_docs_pids": rec["bm25_hard_neg_docs_pids"],
                "pseudo_prepos_docs": pseudo_docs,
                "pseudo_prepos_docs_pids": pseudo_pids,
                "prepos_neg_docs": pn_docs,
                "prepos_neg_docs_pids": pn_pids,
                "rel_label": rel_label,
            }
        )
    write_jsonl(out, output_file)
