"""IR metrics with trec_eval-compatible semantics.

The reference computes MRR / NDCG@3 / Recall@{5,10,20,100} / MAP through
pytrec_eval (src/test_HAConvDR_topiocqa.py:288-353).  pytrec_eval is C++
trec_eval bindings; this module reimplements the same measures natively:

  * ranking: run docs sorted by score descending, ties broken by document
    id DESCENDING (trec_eval's canonical sort);
  * binarization: MRR / Recall / MAP use qrels binarized at
    ``rel_threshold`` upstream (src/test_HAConvDR_topiocqa.py:311-315);
    NDCG uses raw graded rels (":308-309");
  * ndcg_cut.k: DCG = sum rel_i / log2(i+1) over the top k (trec_eval's
    graded-gain form), ideal from qrels sorted by rel desc;
  * queries evaluated = intersection of run and qrel query ids, matching
    pytrec_eval's RelevanceEvaluator.evaluate.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Tuple

Qrels = Mapping[str, Mapping[str, int]]
Run = Mapping[str, Mapping[str, float]]


def _ranked_docs(doc_scores: Mapping[str, float]) -> List[str]:
    # score desc, docid desc — trec_eval tie-break
    return [d for d, _ in sorted(doc_scores.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)]


def _recip_rank(ranked: List[str], rel: Mapping[str, int]) -> float:
    for i, d in enumerate(ranked):
        if rel.get(d, 0) > 0:
            return 1.0 / (i + 1)
    return 0.0


def _recall_at(ranked: List[str], rel: Mapping[str, int], k: int) -> float:
    num_rel = sum(1 for v in rel.values() if v > 0)
    if num_rel == 0:
        return 0.0
    found = sum(1 for d in ranked[:k] if rel.get(d, 0) > 0)
    return found / num_rel


def _average_precision(ranked: List[str], rel: Mapping[str, int]) -> float:
    num_rel = sum(1 for v in rel.values() if v > 0)
    if num_rel == 0:
        return 0.0
    hits = 0
    total = 0.0
    for i, d in enumerate(ranked):
        if rel.get(d, 0) > 0:
            hits += 1
            total += hits / (i + 1)
    return total / num_rel


def _ndcg_cut(ranked: List[str], graded: Mapping[str, int], k: int) -> float:
    dcg = 0.0
    for i, d in enumerate(ranked[:k]):
        g = graded.get(d, 0)
        if g > 0:
            dcg += g / math.log2(i + 2)
    ideal = sorted((g for g in graded.values() if g > 0), reverse=True)[:k]
    idcg = sum(g / math.log2(i + 2) for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def evaluate_run(
    run: Run,
    qrels_binary: Qrels,
    qrels_graded: Qrels,
    recall_ks: Iterable[int] = (5, 10, 20, 100),
    ndcg_k: int = 3,
) -> Dict[str, Dict[str, float]]:
    """Per-query measures for queries present in both run and qrels."""
    out: Dict[str, Dict[str, float]] = {}
    for qid, doc_scores in run.items():
        if qid not in qrels_binary:
            continue
        ranked = _ranked_docs(doc_scores)
        rel = qrels_binary[qid]
        m = {
            "recip_rank": _recip_rank(ranked, rel),
            "map": _average_precision(ranked, rel),
            f"ndcg_cut_{ndcg_k}": _ndcg_cut(ranked, qrels_graded.get(qid, {}), ndcg_k),
        }
        for k in recall_ks:
            m[f"recall_{k}"] = _recall_at(ranked, rel, k)
        out[qid] = m
    return out


def trec_metrics(
    run: Run,
    qrels_binary: Qrels,
    qrels_graded: Qrels,
) -> Tuple[Dict[str, float], Dict[str, Dict[str, float]]]:
    """Aggregate exactly the measures printed by the reference
    (src/test_HAConvDR_topiocqa.py:340-348): MRR / NDCG@3 / Recall@10 /
    Recall@100, x100 rounded to 5 decimals, plus the computed-but-unreported
    extras (MAP, Recall@5/20)."""
    per_q = evaluate_run(run, qrels_binary, qrels_graded)
    if not per_q:
        return {}, {}

    def avg(key):
        vals = [m[key] for m in per_q.values()]
        return sum(vals) / len(vals)

    res = {
        "MRR": round(avg("recip_rank") * 100, 5),
        "NDCG@3": round(avg("ndcg_cut_3") * 100, 5),
        "Recall@10": round(avg("recall_10") * 100, 5),
        "Recall@100": round(avg("recall_100") * 100, 5),
        "Recall@5": round(avg("recall_5") * 100, 5),
        "Recall@20": round(avg("recall_20") * 100, 5),
        "MAP": round(avg("map") * 100, 5),
    }
    return res, per_q
