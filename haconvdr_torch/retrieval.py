"""End-to-end retrieval evaluation (counterpart of haconvdr_tpu/retrieval.py,
the reference's test_HAConvDR_* / test_PRJ_* main flows).

Pipeline: build test examples -> encode queries with an ``AnceEncoder`` ->
blocked exact top-k over the embedding store (``BlockSearcher``: the v4
search on a first block of ``v4_min_rows`` rows or more, the seeded v3
kernel on every later block) -> offset->pid dedup -> TREC run + metrics.
PRJ labeling runs the same machinery over probe queries and applies the
MRR-diff judge.

Where the JAX flow takes (params, mesh), this one takes the encoder
module and runs on its device, or data-parallel over a ``mesh``
(parallel/mesh.py); the search runs on ``device`` (the card unless the
caller passes ``"cpu"``), as JAX's streamed ``BlockSearcher`` runs on one
device.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from haconvdr_torch.config import ExperimentConfig
from haconvdr_torch.device import DeviceLike
from haconvdr_torch.eval.metrics import evaluate_run
from haconvdr_torch.eval.trec import (
    dedup_ranked_candidates,
    print_trec_res,
    read_qrels,
    write_run,
)
from haconvdr_torch.index.store import EmbeddingBlockStore
from haconvdr_torch.mine.prj import improve_judge, judge_stats, rel_label_records
from haconvdr_torch.ops.topk import BlockSearcher
from haconvdr_torch.parallel.mesh import Mesh
from haconvdr_torch.parallel.sharded_encode import batch_iter, encode_batches
from haconvdr_torch.utils.io import pload, write_jsonl

logger = logging.getLogger(__name__)


def build_test_examples(cfg: ExperimentConfig, tokenizer) -> List[dict]:
    d = cfg.data
    if d.dataset == "topiocqa":
        from haconvdr_torch.data.topiocqa import build_topiocqa_test_examples

        return build_topiocqa_test_examples(d, tokenizer, d.test_file_path)
    if d.dataset == "qrecc":
        from haconvdr_torch.data.qrecc import build_qrecc_examples

        return build_qrecc_examples(d, tokenizer, d.test_file_path)
    if d.dataset == "cast":
        from haconvdr_torch.data.cast import build_cast_test_examples

        return build_cast_test_examples(d, tokenizer, d.test_file_path)
    raise ValueError(f"unknown dataset {d.dataset!r}")


_QUERY_KEY = {
    "raw": "raw_query",
    "rewrite": "rewrite",
    "convq": "conv_q",
    "convqa": "conv_qa",
    "convqp": "conv_qp",
    "pair": "pair_query",
}


def get_test_query_embeddings(
    cfg: ExperimentConfig, encoder: torch.nn.Module,
    examples: Optional[List[dict]] = None, tokenizer=None, query_key: Optional[str] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[np.ndarray, List[str]]:
    """Encode test queries on the encoder's device, in batches of
    ``per_device_test_batch_size``, or on a ``mesh`` in batches of that
    many rows a slot, cut over its dp slots, the encoder replicated (one
    tp slot of a dp row runs it, as JAX replicates its params over any
    mesh) (reference get_test_query_embedding,
    src/test_HAConvDR_topiocqa.py:165-219; haconvdr_tpu/retrieval.py:69-86)."""
    if examples is None:
        examples = build_test_examples(cfg, tokenizer)
    key = query_key or _QUERY_KEY[cfg.search.test_type]
    n_dev = 1 if mesh is None else mesh.size
    batches = batch_iter(examples, cfg.search.per_device_test_batch_size * n_dev, shuffle=False)
    return encode_batches(encoder, batches, key, f"{key}_mask", mesh if n_dev > 1 else None)


def search_embedding_store(
    cfg: ExperimentConfig,
    query_embs: np.ndarray,
    store: Optional[EmbeddingBlockStore] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Blocked search over the on-disk embedding store with the merge on
    ``device`` (reference search_one_by_one_with_faiss,
    src/test_HAConvDR_topiocqa.py:74-162); logs the pass as the JAX
    package does (the whole pass and its cost per query)."""
    s = cfg.search
    store = store or EmbeddingBlockStore.open_auto(s.passage_embeddings_dir_path)
    sb_scale = (
        store.global_scale()
        if s.superblock_dtype == "int8" and s.superblock_rows
        else None
    )
    searcher = BlockSearcher(
        top_k=s.top_k, passage_chunk=s.passage_chunk, query_chunk=s.query_chunk,
        device=device, superblock_rows=s.superblock_rows,
        superblock_dtype=s.superblock_dtype, superblock_scale=sb_scale,
    )
    t0 = time.time()
    n_blocks = 0

    def counted_blocks():
        nonlocal n_blocks
        # int8 blocks stream as raw codes; BlockSearcher folds each
        # block's dequant scale into the queries
        for blk in store.iter_blocks(s.passage_block_num, with_scales=True):
            n_blocks += 1
            yield blk

    result = searcher.search(query_embs, counted_blocks())
    elapsed = time.time() - t0
    logger.info(
        {"blocks": n_blocks, "time cost": elapsed,
         "query num": query_embs.shape[0],
         "time cost per query": elapsed / max(1, query_embs.shape[0])}
    )
    return result


def _ranked(cfg, query_embs, query_ids, store, offset2pid, device):
    """Search, then map offsets to pids and dedup per query."""
    s = cfg.search
    scores, offsets = search_embedding_store(cfg, query_embs, store, device)
    if offset2pid is None and s.passage_offset2pid_path:
        offset2pid = pload(s.passage_offset2pid_path)
    return dedup_ranked_candidates(query_ids, scores, offsets, offset2pid, s.top_k)


def gen_metric_score_and_save(
    cfg: ExperimentConfig,
    query_embs: np.ndarray,
    query_ids: Sequence[str],
    store: Optional[EmbeddingBlockStore] = None,
    offset2pid: Optional[List[int]] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Search + dedup + TREC output + metrics
    (src/test_HAConvDR_topiocqa.py:355-372)."""
    s = cfg.search
    ranked = _ranked(cfg, query_embs, query_ids, store, offset2pid, device)
    os.makedirs(s.qrel_output_path, exist_ok=True)
    out_file = os.path.join(s.qrel_output_path, s.output_trec_file)
    write_run(ranked, out_file)
    if s.trec_gold_qrel_file_path:
        return print_trec_res(out_file, s.trec_gold_qrel_file_path, s.rel_threshold)
    return {}


def run_prj_labeling(
    cfg: ExperimentConfig,
    encoder: Optional[torch.nn.Module],
    probe_records: List[dict],
    probe_qrel_file: str,
    tokenizer,
    qrel_ids: Optional[set] = None,
    store: Optional[EmbeddingBlockStore] = None,
    offset2pid: Optional[List[int]] = None,
    query_embs: Optional[np.ndarray] = None,
    query_ids: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, List[int]]:
    """Probe retrieval -> per-probe MRR -> rel labels (the reference's
    test_PRJ_* main flow, src/test_PRJ_topiocqa.py:495-527 + improve_judge).
    Pass precomputed (query_embs, query_ids), and no encoder, for the
    5-fold cross-validate flow (":501-523"), which concatenates per-fold-
    model embeddings.  The encode runs on ``mesh`` when given
    (haconvdr_tpu/retrieval.py:165-190); the search runs on ``device``, by
    default the encoder's device (the card when there is no encoder)."""
    from haconvdr_torch.data.prj import build_prj_probe_examples

    if device is None and encoder is not None:
        device = next(encoder.parameters()).device
    if query_embs is None:
        with tempfile.TemporaryDirectory() as tmp:
            probe_file = os.path.join(tmp, "probes.json")
            with open(probe_file, "w") as f:
                for rec in probe_records:
                    f.write(json.dumps(rec) + "\n")
            examples = build_prj_probe_examples(cfg.data, tokenizer, probe_file)
        embs, ids = get_test_query_embeddings(
            cfg, encoder, examples=examples, query_key="pair_query", mesh=mesh
        )
    else:
        embs, ids = query_embs, list(query_ids)
    ranked = _ranked(cfg, embs, ids, store, offset2pid, device)
    run = {
        qid: {str(pid): float(200 - r - 1) for r, (pid, _) in enumerate(lst)}
        for qid, lst in ranked.items()
    }
    qrels, qrels_graded = read_qrels(probe_qrel_file, cfg.search.rel_threshold)
    per_q = evaluate_run(run, qrels, qrels_graded)
    probe_mrr = {qid: m["recip_rank"] for qid, m in per_q.items()}
    rel = improve_judge(probe_records, probe_mrr, qrel_ids=qrel_ids)
    ones, zeros = judge_stats(rel)
    logger.info("PRJ judge: one=%d zero=%d", ones, zeros)
    return rel


def write_rel_labels(rel: Dict[str, List[int]], out_path: str) -> None:
    write_jsonl(rel_label_records(rel), out_path)
