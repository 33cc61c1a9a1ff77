"""QReCC conversational retrieval dataset builders.

Reimplements the reference QReCC Dataset classes:
  * :func:`build_qrecc_examples` — ``Retrieval_qrecc_new``
    (src/data.py:508-595), the richer variant with pseudo-prepos /
    prepos-neg fields; with ``with_prepos=False`` it degrades to the plain
    ``Retrieval_qrecc`` (src/data.py:381-455) used by
    train_HAConvDR_qrecc;
  * :func:`build_qrecc_multineg_examples` — ``Retrieval_qrecc_negs``
    (src/data.py:745-818), the multi-BM25-negative variant.

QReCC records carry explicit ``ctx_utts_text`` / ``cur_utt_text`` fields
(preprocess/preprocess_qrecc.py:124-142), unlike TopiOCQA's [SEP]-joined
string.  The PRL path appends (answer, query) of each label-1 history turn
WITHOUT the concat-length overflow rule (src/data.py:542-555) — only final
padding truncates; the non-PRL path walks full history newest-first WITH
the overflow rule (src/data.py:556-567).  Records with no positive passage
are skipped (src/data.py:527-528).
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional

from haconvdr_torch.config import DataConfig
from haconvdr_torch.data.sequence import (
    ConcatBuilder,
    encode_no_trunc,
    encode_trunc,
    pad_seq_to_length,
)


def _read_records(filename: str) -> List[dict]:
    with open(filename, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _build_conv_qa(cfg: DataConfig, tokenizer, records, i) -> List[int]:
    record = records[i]
    rel_label = record["rel_label"]
    ids: List[int] = list(
        encode_no_trunc(tokenizer, record["cur_utt_text"], cfg.max_query_length)
    )
    if cfg.use_PRL:
        # label-1 history turns, newest first; answer then query; turns with
        # empty answers contribute query only (src/data.py:542-555)
        for index in range(len(rel_label) - 1, -1, -1):
            if rel_label[index] == 0:
                continue
            rel_rec = records[i - (len(rel_label) - index)]
            utt_q = encode_trunc(tokenizer, rel_rec["cur_utt_text"], cfg.max_query_length)
            utt_a_text = rel_rec["cur_response_text"]
            if len(utt_a_text) == 0:
                ids.extend(utt_q)
            else:
                ids.extend(
                    encode_trunc(tokenizer, utt_a_text, cfg.max_response_length)
                )
                ids.extend(utt_q)
        return ids
    builder = ConcatBuilder(cfg.max_concat_length)
    builder.ids.extend(ids)
    ctx_utts_text = record["ctx_utts_text"]
    for j in range(len(ctx_utts_text) - 1, -1, -1):
        max_length = cfg.max_response_length if j % 2 == 1 else cfg.max_query_length
        if not builder.add(encode_trunc(tokenizer, ctx_utts_text[j], max_length)):
            break
    return builder.ids


def build_qrecc_examples(
    cfg: DataConfig,
    tokenizer,
    filename: str,
    rng: Optional[random.Random] = None,
    with_prepos: bool = True,
) -> List[Dict]:
    rng = rng or random.Random(cfg.seed)
    records = _read_records(filename)
    examples: List[Dict] = []
    for i, record in enumerate(records):
        pos_docs_text = record["pos_docs_text"]
        if len(pos_docs_text) == 0:
            continue
        conv_qa, conv_qa_mask = pad_seq_to_length(
            _build_conv_qa(cfg, tokenizer, records, i), cfg.max_concat_length
        )
        example: Dict = {
            "sample_id": record["sample_id"],
            "conv_qa": conv_qa,
            "conv_qa_mask": conv_qa_mask,
        }
        if cfg.is_train:
            pos_ids = encode_trunc(tokenizer, pos_docs_text[0], cfg.max_doc_length)
            neg_ids = encode_trunc(
                tokenizer, record["bm25_hard_neg_docs"][0], cfg.max_doc_length
            )
            example["pos_docs"], example["pos_docs_mask"] = pad_seq_to_length(
                pos_ids, cfg.max_doc_length
            )
            example["neg_docs"], example["neg_docs_mask"] = pad_seq_to_length(
                neg_ids, cfg.max_doc_length
            )
            if with_prepos:
                pseudo_texts = record.get("pseudo_prepos_docs", [])
                prepos_texts = record.get("prepos_neg_docs", [])
                if len(pseudo_texts) > 0:
                    ids = encode_trunc(
                        tokenizer, rng.choice(pseudo_texts), cfg.max_doc_length
                    )
                    example["has_pseudo_prepos"] = 1
                else:
                    ids, example["has_pseudo_prepos"] = [], 0
                (
                    example["pseudo_prepos_docs"],
                    example["pseudo_prepos_docs_mask"],
                ) = pad_seq_to_length(ids, cfg.max_doc_length)
                if len(prepos_texts) > 0:
                    ids = encode_trunc(
                        tokenizer, rng.choice(prepos_texts), cfg.max_doc_length
                    )
                    example["has_prepos_neg"] = 1
                else:
                    ids, example["has_prepos_neg"] = [], 0
                (
                    example["prepos_neg_docs"],
                    example["prepos_neg_docs_mask"],
                ) = pad_seq_to_length(ids, cfg.max_doc_length)
        examples.append(example)
    return examples


def build_qrecc_multineg_examples(
    cfg: DataConfig,
    tokenizer,
    filename: str,
    num_negs: int = 3,
    rng: Optional[random.Random] = None,
) -> List[Dict]:
    """Port of Retrieval_qrecc_negs (src/data.py:745-818): a random positive
    and ALL bm25 hard negatives per example.  For static shapes the negative
    list is clamped/padded to ``num_negs`` with a count field."""
    rng = rng or random.Random(cfg.seed)
    records = _read_records(filename)
    examples: List[Dict] = []
    for i, record in enumerate(records):
        pos_docs_text = record["pos_docs_text"]
        if len(pos_docs_text) == 0:
            continue
        conv_qa, conv_qa_mask = pad_seq_to_length(
            _build_conv_qa(cfg, tokenizer, records, i), cfg.max_concat_length
        )
        example: Dict = {
            "sample_id": record["sample_id"],
            "conv_qa": conv_qa,
            "conv_qa_mask": conv_qa_mask,
        }
        if cfg.is_train:
            pos_ids = encode_trunc(
                tokenizer, rng.choice(pos_docs_text), cfg.max_doc_length
            )
            example["pos_docs"], example["pos_docs_mask"] = pad_seq_to_length(
                pos_ids, cfg.max_doc_length
            )
            negs, neg_masks = [], []
            for neg_text in record["bm25_hard_neg_docs"][:num_negs]:
                ids = encode_trunc(tokenizer, neg_text, cfg.max_doc_length)
                ids, mask = pad_seq_to_length(ids, cfg.max_doc_length)
                negs.append(ids)
                neg_masks.append(mask)
            example["num_negs"] = len(negs)
            while len(negs) < num_negs:
                negs.append([0] * cfg.max_doc_length)
                neg_masks.append([0] * cfg.max_doc_length)
            example["neg_docs"] = negs
            example["neg_docs_mask"] = neg_masks
        examples.append(example)
    return examples
