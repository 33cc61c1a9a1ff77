"""TREC run-file IO and end-of-search result formatting.

Rebuilds the reference output path (src/test_HAConvDR_topiocqa.py:222-353):
offset->pid mapping, per-query pid dedup preserving rank order, TREC run
writing in the reference's exact column layout
(``qid Q0 pid rank (200-rank) score ance``), qrel parsing with
rel_threshold binarization, and the metric printout.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from haconvdr_torch.eval.metrics import trec_metrics

logger = logging.getLogger(__name__)


def dedup_ranked_candidates(
    query_ids: Sequence[str],
    retrieved_scores: np.ndarray,  # [Q, >=topN]
    retrieved_offsets: np.ndarray,  # [Q, >=topN] embedding offsets
    offset2pid: Sequence[int],
    top_n: int,
) -> Dict[str, List[Tuple[int, float]]]:
    """Map offsets to pids and deduplicate per query, preserving rank order.

    Mirrors output_test_res (src/test_HAConvDR_topiocqa.py:229-255)
    including its quirks: only the first ``top_n`` retrieved entries are
    scanned, duplicate pids are dropped, and unfilled tail ranks stay as
    the (0, 0) placeholder.  Repeated query ids keep the first occurrence
    (":242-247").
    """
    out: Dict[str, List[Tuple[int, float]]] = {}
    for qi, qid in enumerate(query_ids):
        if qid in out:
            continue
        ranked: List[Tuple[int, float]] = [(0, 0.0)] * top_n
        seen = set()
        rank = 0
        for idx, score in zip(
            retrieved_offsets[qi][:top_n], retrieved_scores[qi][:top_n]
        ):
            if int(idx) < 0:  # unfilled slot (corpus smaller than top_n)
                continue
            pid = offset2pid[int(idx)] if offset2pid is not None else int(idx)
            if pid in seen:
                continue
            ranked[rank] = (pid, float(score))
            rank += 1
            seen.add(pid)
        out[qid] = ranked
    return out


def write_run(
    qid_to_ranked: Mapping[str, List[Tuple[int, float]]],
    output_trec_file: str,
    tag: str = "ance",
) -> None:
    """Reference line format (src/test_HAConvDR_topiocqa.py:276-283)."""
    with open(output_trec_file, "w") as g:
        for qid, passages in qid_to_ranked.items():
            for i, (pid, score) in enumerate(passages):
                g.write(
                    f"{qid} Q0 {pid} {i + 1} {-i - 1 + 200} {score} {tag}\n"
                )


def read_qrels(
    qrel_file: str, rel_threshold: int = 1
) -> Tuple[Dict[str, Dict[str, int]], Dict[str, Dict[str, int]]]:
    """Parse a qrel file (space- or tab-separated) into (binary, graded)
    qrel dicts (src/test_HAConvDR_topiocqa.py:298-315)."""
    qrels: Dict[str, Dict[str, int]] = {}
    qrels_ndcg: Dict[str, Dict[str, int]] = {}
    with open(qrel_file, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            query, _, passage, rel = parts[0], parts[1], parts[2], int(parts[3])
            qrels_ndcg.setdefault(query, {})[passage] = rel
            qrels.setdefault(query, {})[passage] = 1 if rel >= rel_threshold else 0
    return qrels, qrels_ndcg


def read_run(run_file: str) -> Dict[str, Dict[str, float]]:
    """Parse a run file; the 5th column (200-rank) is the score used for
    evaluation, exactly as the reference does
    (src/test_HAConvDR_topiocqa.py:317-324)."""
    runs: Dict[str, Dict[str, float]] = {}
    with open(run_file, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            runs.setdefault(parts[0], {})[parts[2]] = float(parts[4])
    return runs


def print_trec_res(
    run_file: str, qrel_file: str, rel_threshold: int = 1
) -> Dict[str, float]:
    """Evaluate a run file against gold qrels; returns the reference's
    reported dict {MRR, NDCG@3, Recall@10, Recall@100}
    (src/test_HAConvDR_topiocqa.py:288-353) plus the extra computed ones."""
    runs = read_run(run_file)
    qrels, qrels_ndcg = read_qrels(qrel_file, rel_threshold)
    res, _ = trec_metrics(runs, qrels, qrels_ndcg)
    logger.info("---------------------Evaluation results:---------------------")
    logger.info(res)
    return res


def output_test_res(
    query_ids: Sequence[str],
    retrieved_scores: np.ndarray,
    retrieved_offsets: np.ndarray,
    offset2pid: Sequence[int],
    top_n: int,
    output_trec_file: str,
    qrel_file: str = "",
    rel_threshold: int = 1,
    tag: str = "ance",
) -> Dict[str, float]:
    """End-to-end: dedup + write run + (optionally) evaluate.
    Mirrors output_test_res (src/test_HAConvDR_topiocqa.py:222-286)."""
    ranked = dedup_ranked_candidates(
        query_ids, retrieved_scores, retrieved_offsets, offset2pid, top_n
    )
    write_run(ranked, output_trec_file, tag=tag)
    logger.info("output file written at %s", output_trec_file)
    if qrel_file:
        return print_trec_res(output_trec_file, qrel_file, rel_threshold)
    return {}
