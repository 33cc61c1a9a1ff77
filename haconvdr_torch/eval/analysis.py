"""Result analysis utilities beyond the headline metrics.

  * :func:`print_res` — the reference's JSON-format evaluator
    (src/utils.py:230-274): rank the gold positive inside a ctxs list,
    compute MRR / NDCG (log2 discount) / R@n at several depths;
  * :func:`metric_by_turn` — per-turn-depth breakdown of a per-query
    metric, the reference's context_affect analysis
    (bm25/bm25_qrecc.py:214-224): how retrieval quality degrades as the
    conversation gets deeper.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Mapping, Sequence

logger = logging.getLogger(__name__)


def print_res(result_data: Sequence[dict], gold_data: Sequence[dict]) -> Dict[str, float]:
    """result_data[i] = {conv_id, turn_id, ctxs: [{doc_id, ...}]};
    gold_data[i] = {conv_id, turn_id, positive_ctxs: [{passage_id}]}.
    Unfound golds count as rank 1000 (src/utils.py:243-257)."""
    ranks: List[float] = []
    mrr = 0.0
    ndcg = 0.0
    for i, sample in enumerate(gold_data):
        assert str(sample["conv_id"]) == str(result_data[i]["conv_id"])
        assert str(sample["turn_id"]) == str(result_data[i]["turn_id"])
        gold_ctx = sample["positive_ctxs"][0]
        assigned = False
        for rank, ctx in enumerate(result_data[i]["ctxs"]):
            if str(ctx["doc_id"]) == str(gold_ctx["passage_id"]):
                mrr += 1.0 / (rank + 1)
                ndcg += 1.0 / math.log2(rank + 2)
                ranks.append(float(rank + 1))
                assigned = True
                break
        if not assigned:
            ranks.append(1000.0)

    final: Dict[str, float] = {}
    for n in (1, 3, 5, 10, 20, 30, 50, 100):
        score = (
            0.0
            if not ranks
            else len([x for x in ranks if x <= n]) * 100.0 / len(ranks)
        )
        final[f"R@{n}"] = round(score, 2)
    final["MRR"] = round(mrr * 100.0 / len(ranks), 2) if ranks else 0.0
    final["NDCG"] = round(ndcg * 100.0 / len(ranks), 2) if ranks else 0.0
    logger.info("Evaluation results: %s", final)
    return final


def metric_by_turn(
    per_query_metric: Mapping[str, float], max_turn: int = 16
) -> Dict[int, float]:
    """Average a per-query metric by turn depth.  Query ids end in the turn
    number in both reference id layouts ('Tag_conv_turn' and 'conv-turn')."""
    buckets: Dict[int, List[float]] = {}
    for qid, value in per_query_metric.items():
        token = qid.replace("-", "_").split("_")[-1]
        try:
            turn = int(token)
        except ValueError:
            continue
        turn = min(turn, max_turn)
        buckets.setdefault(turn, []).append(value)
    return {
        t: sum(v) / len(v) for t, v in sorted(buckets.items())
    }
