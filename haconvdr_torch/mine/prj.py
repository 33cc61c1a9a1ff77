"""PRJ (pseudo relevance judgment) mining — the pass that makes this
pipeline "history-aware".

Probe generation expands each turn > 1 into one record per history turn
(reference preprocess/PRJ_topiocqa.py:238-300, PRJ_qrecc.py:17-66); dense
retrieval runs over the probes; :func:`improve_judge` converts per-probe
MRR into binary per-history-turn labels: ``rel_label[k] = 1`` iff
MRR(query (+) history-turn-k) > MRR(bare query)
(src/test_PRJ_topiocqa.py:443-472, src/test_PRJ_qrecc.py:403-446).

All functions operate on record dicts / return record dicts; file IO is at
the CLI layer.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Probe generation
# ---------------------------------------------------------------------------

def create_label_rel_turn(records: Iterable[dict], dataset: str = "topiocqa") -> List[dict]:
    """Expand each turn>1 into probes: '<conv>-<turn>-0' (bare query) plus
    '<conv>-<turn>-<k>' per history query k.

    TopiOCQA records carry conv_id/turn_id/history_query/...
    (preprocess/PRJ_topiocqa.py:238-300); QReCC records carry
    sample_id 'conv-turn' + context_queries and skip empty-positive turns
    (preprocess/PRJ_qrecc.py:17-66).
    """
    probes: List[dict] = []
    for rec in records:
        if dataset == "qrecc":
            sample_id = rec["sample_id"]
            conv_id, turn_id = sample_id.split("-")[0], sample_id.split("-")[1]
            history_query = rec["context_queries"]
            pos_docs_id = rec.get("pos_docs") or []
            if len(pos_docs_id) == 0:
                continue
            extra = {"last_response": rec.get("last_response", "")}
            rewrites = None
        else:
            conv_id, turn_id = rec["conv_id"], rec["turn_id"]
            history_query = rec["history_query"]
            pos_docs_id = rec["pos_docs_id"]
            extra = {
                "history_answer": rec.get("history_answer", []),
                "last_response": rec.get("last_response", ""),
                "topic": rec.get("topic", ""),
                "sub_topic": rec.get("sub_topic", ""),
                "pos_docs": rec.get("pos_docs", []),
            }
            rewrites = rec.get("history_rewrite")

        if int(turn_id) <= 1:
            continue
        base = {
            "conv_id": conv_id,
            "turn_id": turn_id,
            "query": rec["query"],
            "pos_docs_id": pos_docs_id,
            **extra,
        }
        if "rewrite" in rec:
            base["rewrite"] = rec["rewrite"]
        probes.append(
            {"id": f"{conv_id}-{turn_id}-0", "query_pair": "", "rewrite_query_pair": "", **base}
        )
        for tid in range(int(turn_id) - 1):
            probe = {
                "id": f"{conv_id}-{turn_id}-{tid + 1}",
                "query_pair": history_query[tid],
                **base,
            }
            if rewrites is not None and tid < len(rewrites):
                probe["rewrite_query_pair"] = rewrites[tid]
            probes.append(probe)
    return probes


def create_label_rel_token(records: Iterable[dict]) -> List[dict]:
    """Token-level probe variant (preprocess/PRJ_topiocqa.py:302-353):
    one probe per whitespace token of the concatenated history queries."""
    probes: List[dict] = []
    for rec in records:
        conv_id, turn_id = rec["conv_id"], rec["turn_id"]
        if int(turn_id) <= 1:
            continue
        token_set: List[str] = []
        for q in rec["history_query"]:
            token_set.extend(q.strip().split())
        base = {
            "conv_id": conv_id,
            "turn_id": turn_id,
            "query": rec["query"],
            "pos_docs_id": rec["pos_docs_id"],
        }
        probes.append({"id": f"{conv_id}-{turn_id}-0", "query_pair": "", **base})
        for tid, token in enumerate(token_set):
            probes.append(
                {"id": f"{conv_id}-{turn_id}-{tid + 1}", "query_pair": token, **base}
            )
    return probes


def create_topic_rel_turn(records: Sequence[dict], mode: str = "topic") -> List[dict]:
    """Topic-oracle labels (preprocess/PRJ_topiocqa.py:355-418):
    rel_label[k] = 1 iff history turn k shares the (sub_)topic."""
    out: List[dict] = []
    conv_start = 0
    records = list(records)
    for i, rec in enumerate(records):
        conv_id, turn_id = rec["conv_id"], rec["turn_id"]
        if int(turn_id) == 1:
            conv_start = i
            out.append(
                {"id": f"{conv_id}-{turn_id}", "conv_id": str(conv_id),
                 "turn_id": str(turn_id), "rel_label": []}
            )
            continue
        labels = []
        for j in range(conv_start, i):
            labels.append(1 if rec[mode] == records[j][mode] else 0)
        out.append(
            {"id": f"{conv_id}-{turn_id}", "conv_id": str(conv_id),
             "turn_id": str(turn_id), "rel_label": labels}
        )
    return out


def convert_gold_to_trec(records: Iterable[dict]) -> List[str]:
    """Probe records -> gold qrel lines 'id Q0 pid 1'
    (preprocess/PRJ_topiocqa.py:455-468); empty positives skipped
    (PRJ_qrecc.py:69-87)."""
    lines = []
    for rec in records:
        pids = rec.get("pos_docs_id") or []
        if len(pids) == 0:
            continue
        lines.append(f"{rec['id']} Q0 {pids[0]} 1")
    return lines


def create_prj_triples(
    label_records: Sequence[dict], query_records: Sequence[dict], dataset: str = "topiocqa"
) -> List[dict]:
    """(query, history query, label) classifier-training triples
    (preprocess/PRJ_topiocqa.py:470-504; qrecc id-matching walk,
    PRJ_qrecc.py:89-127)."""
    out: List[dict] = []
    ones = zeros = 0
    if dataset == "qrecc":
        idx = 0
        for qrec in query_records:
            if idx >= len(label_records):
                break
            lrec = label_records[idx]
            if lrec["id"] != qrec["sample_id"]:
                continue
            history = qrec["context_queries"]
            labels = lrec["rel_label"]
            assert len(history) == len(labels)
            for k in range(len(history)):
                ones += labels[k] == 1
                zeros += labels[k] != 1
                out.append(
                    {"id": f"{lrec['id']}-{k + 1}", "query": qrec["query"],
                     "rel_query": history[k], "rel_label": labels[k]}
                )
            idx += 1
    else:
        assert len(label_records) == len(query_records)
        for lrec, qrec in zip(label_records, query_records):
            history = qrec["history_query"]
            labels = lrec["rel_label"]
            assert len(history) == len(labels)
            for k in range(len(history)):
                ones += labels[k] == 1
                zeros += labels[k] != 1
                out.append(
                    {"id": f"{lrec['id']}-{k + 1}", "query": qrec["query"],
                     "rel_query": history[k], "rel_label": labels[k]}
                )
    logger.info("PRJ triples: one=%d zero=%d", ones, zeros)
    return out


# ---------------------------------------------------------------------------
# MRR-diff judging
# ---------------------------------------------------------------------------

def improve_judge(
    probe_records: Sequence[dict],
    probe_mrr: Mapping[str, float],
    qrel_ids: Optional[set] = None,
) -> Dict[str, List[int]]:
    """Per-probe MRR -> {'conv-turn': rel_label list}.

    Mirrors improve_judge (src/test_PRJ_topiocqa.py:443-472): within each
    (conv, turn) group the '-0' probe sets the base score; probe k gets
    label 1 iff its MRR strictly exceeds the base.  Turn-1 entries are
    emitted with empty labels.  The QReCC variant additionally restricts
    turn-1 emission to conversations present in the original qrels
    (``qrel_ids``, src/test_PRJ_qrecc.py:404-446) and flushes on
    conversation boundaries even when turn ids collide.

    Robustness divergence (documented): probes are keyed by id — scores are
    looked up per probe id instead of relying on file-line / pytrec_eval
    ordering alignment; group flushes use (conv, turn) pairs.
    """
    rel_label: Dict[str, List[int]] = {}
    rel_list: List[int] = []
    base_score = 0.0
    n = len(probe_records)
    for i, rec in enumerate(probe_records):
        id_list = rec["id"].split("-")
        conv_id, turn_id, type_id = id_list[0], id_list[1], int(id_list[-1])
        score = float(probe_mrr.get(rec["id"], 0.0))
        if type_id == 0 and int(turn_id) > 1:
            base_score = score
        elif type_id > 0 and int(turn_id) > 1:
            rel_list.append(1 if score > base_score else 0)

        flush = i + 1 == n
        if not flush:
            nxt = probe_records[i + 1]["id"].split("-")
            flush = (nxt[0], nxt[1]) != (conv_id, turn_id)
        if flush:
            if qrel_ids is None or f"{conv_id}-1" in qrel_ids:
                rel_label[f"{conv_id}-1"] = []
            rel_label[f"{conv_id}-{turn_id}"] = rel_list
            rel_list = []
            base_score = 0.0
    return rel_label


def rel_label_records(rel_label: Mapping[str, List[int]]) -> List[dict]:
    """{'conv-turn': labels} -> jsonl-able records
    (src/test_PRJ_topiocqa.py:379-390)."""
    out = []
    for key, value in rel_label.items():
        conv_id, turn_id = key.split("-")[0], key.split("-")[1]
        out.append(
            {"id": key, "conv_id": conv_id, "turn_id": turn_id, "rel_label": value}
        )
    return out


def judge_stats(rel_label: Mapping[str, List[int]]) -> Tuple[int, int]:
    """(one_nums, zero_nums) bookkeeping printed by the reference
    (src/test_PRJ_topiocqa.py:366-377)."""
    ones = zeros = 0
    for value in rel_label.values():
        if (len(value) > 0 and 1 in value[1:]) or len(value) == 1:
            ones += 1
        elif len(value) > 0 and 1 not in value[1:]:
            zeros += 1
    return ones, zeros
