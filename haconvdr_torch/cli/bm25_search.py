"""CLI: BM25 retrieval for hard-negative mining (counterpart of
haconvdr_tpu/cli/bm25_search.py, the reference's bm25/bm25_topiocqa.py /
bm25_qrecc.py + create_index.sh).  It runs on the host and takes no
``--device``.

Two subcommands (first positional arg):
  index   — build a BM25 index from a collection TSV
            (bm25.index_dir_path=..., data.collection_path=...)
  search  — run batch retrieval with a query-construction mode
            (query_type raw|rewrite|convq|convqa|convqp|oracle|decode,
            optional PRJ-filtered expansion via prj_file=...; decode mode
            takes eval_type=answer|oracle+answer with a second decoding
            file decode_file=..., bm25/bm25_topiocqa.py:135-142)

The TREC output mirrors the reference line layout
(bm25/bm25_topiocqa.py:157-170).
"""

import logging
import sys
from typing import List, Optional

from haconvdr_torch.config import config_from_argv
from haconvdr_torch.mine.bm25 import BM25Index
from haconvdr_torch.preprocess.collections import iter_topiocqa_collection
from haconvdr_torch.utils.io import read_jsonl_list, setup_logging

logger = logging.getLogger(__name__)


def build_query(
    record: dict,
    query_type: str,
    prj: Optional[dict] = None,
    level: str = "turn",
    decode2: Optional[dict] = None,
    eval_type: str = "",
) -> str:
    """Query text construction per mode with optional PRJ-label filtering
    (bm25/bm25_topiocqa.py:43-148).

    ``decode`` mode (bm25/bm25_topiocqa.py:135-142, bm25_qrecc.py:102-109):
    the main file's ``oracle_utt_text`` (an external query decoder's
    output), optionally overridden/extended by a SECOND decoding file's
    ``answer_utt_text`` — eval_type "answer" replaces, "oracle+answer"
    concatenates.  No 510-token clip in this mode, as in the reference.
    """
    if query_type == "decode":
        query = record["oracle_utt_text"]
        if eval_type == "answer":
            query = decode2["answer_utt_text"]
        elif eval_type == "oracle+answer":
            query = query + " " + decode2["answer_utt_text"]
        return query
    if query_type == "raw":
        return record["query"]
    if query_type in ("rewrite", "oracle"):
        return record.get("rewrite") or record.get("oracle_utt_text", "")
    query = ""
    history_query = record.get("history_query", [])
    history_answer = record.get("history_answer", [])
    rel_label = (prj or {}).get("rel_label", [])
    if query_type == "convq":
        if prj is not None and len(rel_label) > 0:
            if level == "token":
                tokens: List[str] = []
                for q in history_query:
                    tokens.extend(q.strip().split())
                for j, lbl in enumerate(rel_label):
                    if lbl == 1 and j < len(tokens):
                        query += tokens[j] + " "
            else:  # turn level, newest first
                for j in range(len(rel_label) - 1, -1, -1):
                    if rel_label[j] == 1:
                        query += history_query[j] + " "
        else:
            for q in history_query:
                query += q + " "
        return record["query"] + " " + query.strip()
    if query_type == "convqa":
        if prj is not None and len(rel_label) > 0:
            for j in range(len(rel_label) - 1, -1, -1):
                if rel_label[j] == 1:
                    query += history_query[j] + " "
                    if j < len(history_answer):
                        query += history_answer[j] + " "
        else:
            for q, a in zip(history_query, history_answer):
                query += q + " " + a + " "
        query = record["query"] + " " + query
    elif query_type == "convqp":
        for q in history_query:
            query += q + " "
        query = query + record["query"] + " " + record.get("last_response", "")
    else:
        raise ValueError(f"unknown query_type {query_type!r}")
    # clip to the trailing 510 whitespace tokens (bm25_topiocqa.py:110-113)
    words = query.strip().split()
    if len(words) > 512:
        words = words[-510:]
    return " ".join(words)


def main(argv=None):
    setup_logging()
    argv = list(sys.argv[1:] if argv is None else argv)
    assert argv and argv[0] in ("index", "search"), "first arg: index|search"
    cmd = argv[0]
    extra = {}
    rest = []
    for a in argv[1:]:
        if any(
            a.startswith(p + "=")
            for p in (
                "query_type", "prj_file", "level", "output_trec",
                "decode_file", "eval_type",
            )
        ):
            k, _, v = a.partition("=")
            extra[k] = v
        else:
            rest.append(a)
    cfg = config_from_argv(rest)

    if cmd == "index":
        idx = BM25Index()
        n = 0
        for pid, passage in iter_topiocqa_collection(cfg.data.collection_path):
            idx.add(str(pid), passage)
            n += 1
            if n % 100000 == 0:
                logger.info("indexed %d passages", n)
        idx.finalize()
        idx.save(cfg.bm25.index_dir_path)
        logger.info("BM25 index saved to %s (%d docs)", cfg.bm25.index_dir_path, n)
        return

    idx = BM25Index.load(cfg.bm25.index_dir_path)
    records = read_jsonl_list(cfg.data.test_file_path)
    prj = None
    if "prj_file" in extra:
        prj_recs = read_jsonl_list(extra["prj_file"])
        assert len(prj_recs) == len(records)
        prj = prj_recs
    query_type = extra.get("query_type", "rewrite")
    level = extra.get("level", "turn")
    eval_type = extra.get("eval_type", "")
    decode2 = None
    if "decode_file" in extra:
        # second decoding file: answer_utt_text per line, aligned with the
        # main file (bm25/bm25_topiocqa.py:28-29)
        decode2 = read_jsonl_list(extra["decode_file"])
        assert len(decode2) == len(records)
    if query_type == "decode" and eval_type in ("answer", "oracle+answer"):
        assert decode2 is not None, (
            "eval_type=answer/oracle+answer needs decode_file=..."
        )
    queries, qids = [], []
    for i, rec in enumerate(records):
        queries.append(
            build_query(
                rec, query_type, prj[i] if prj else None, level,
                decode2=decode2[i] if decode2 else None, eval_type=eval_type,
            )
        )
        qids.append(rec.get("sample_id") or rec.get("id"))

    docs, scores = idx.batch_search(
        queries, k=cfg.bm25.top_k, k1=cfg.bm25.k1, b=cfg.bm25.b,
        n_threads=cfg.bm25.num_threads,
    )
    out_path = extra.get("output_trec", "bm25_res.trec")
    total = 0
    with open(out_path, "w") as f:
        for qi, qid in enumerate(qids):
            for r in range(docs.shape[1]):
                d = docs[qi, r]
                if d < 0:
                    break
                f.write(
                    f"{qid} Q0 {idx.doc_ids[d]} {r + 1} {-r - 1 + 200} "
                    f"{scores[qi, r]} bm25\n"
                )
                total += 1
    logger.info("wrote %d lines to %s", total, out_path)

    if cfg.search.trec_gold_qrel_file_path:
        # metric printout + per-turn MRR breakdown (context_affect,
        # bm25/bm25_qrecc.py:173-244)
        from haconvdr_torch.eval.analysis import metric_by_turn
        from haconvdr_torch.eval.metrics import trec_metrics
        from haconvdr_torch.eval.trec import read_qrels, read_run

        runs = read_run(out_path)
        qrels, qrels_ndcg = read_qrels(
            cfg.search.trec_gold_qrel_file_path, cfg.search.rel_threshold
        )
        res, per_q = trec_metrics(runs, qrels, qrels_ndcg)
        logger.info("BM25 evaluation: %s", res)
        by_turn = metric_by_turn({q: m["recip_rank"] for q, m in per_q.items()})
        logger.info("MRR by turn depth: %s", by_turn)


if __name__ == "__main__":
    main()
