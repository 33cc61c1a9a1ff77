"""TopiOCQA conversational retrieval dataset builders.

Host-side reimplementation of the reference Dataset classes:

  * :func:`build_topiocqa_train_examples` — the training builder the
    reference actually uses, ``Retrieval_topiocqa_new``
    (src/data.py:253-335, selected at src/train_HAConvDR_topiocqa.py:95);
  * :func:`build_topiocqa_test_examples` — the eval builder
    ``Retrieval_topiocqa`` (src/data.py:25-199) as exercised by
    test_HAConvDR_topiocqa (use_PRL=False, is_train=False, convqp inputs).

Known reference defects fixed here (SURVEY.md SS8, documented divergences):
  * src/data.py:333 ``prepos_neg_docss`` NameError -> correct variable;
  * src/data.py:328-333 tokenizing into the same list being sampled ->
    fresh token lists;
  * ragged pseudo/prepos fields that crash torch collate -> fixed-length
    fields plus explicit per-example presence flags
    (``has_pseudo_prepos`` / ``has_prepos_neg``), masked in the loss.
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


def _read_lines(filename: str) -> List[str]:
    with open(filename, encoding="utf-8") as f:
        return f.readlines()


def _split_history(cur_utt_text: str) -> (List[str], str):
    """cur_utt_text is 'q1 [SEP] a1 [SEP] ... [SEP] qk' (src/data.py:267-269)."""
    parts = cur_utt_text.strip().split(" [SEP] ")
    return parts[:-1], parts[-1]


def _append_history_qa(
    builder: ConcatBuilder, ctx_utts: List[str], tokenizer, cfg: DataConfig
) -> None:
    """Newest-first Q/A history with parity-based length caps
    (src/data.py:307-317): even index = query, odd = answer."""
    for j in range(len(ctx_utts) - 1, -1, -1):
        max_length = cfg.max_response_length if j % 2 == 1 else cfg.max_query_length
        utt = encode_trunc(tokenizer, ctx_utts[j], max_length)
        if not builder.add(utt):
            break


def build_topiocqa_train_examples(
    cfg: DataConfig,
    tokenizer,
    filename: str,
    rng: Optional[random.Random] = None,
) -> List[Dict]:
    """Port of Retrieval_topiocqa_new.__init__ (src/data.py:253-335).

    Returns one example dict per input line with keys:
      sample_id, conv_qp / conv_qp_mask  (the history-aware query concat),
      pos_docs / pos_docs_mask, neg_docs / neg_docs_mask (bm25 hard neg),
      pseudo_prepos_docs(+mask, has_pseudo_prepos),
      prepos_neg_docs(+mask, has_prepos_neg).
    """
    rng = rng or random.Random(cfg.seed)
    data = _read_lines(filename)
    records = [json.loads(line) for line in data]
    examples: List[Dict] = []

    for i, record in enumerate(records):
        sample_id = record["sample_id"]
        ctx_utts_text, cur_utt_text = _split_history(record["cur_utt_text"])
        last_response = record["last_response"]
        rel_label = record["rel_label"]

        builder = ConcatBuilder(cfg.max_concat_length)
        cur_utt = encode_no_trunc(tokenizer, cur_utt_text, cfg.max_query_length)
        builder.ids.extend(cur_utt)  # seed segment, never truncated here (src/data.py:280)

        if cfg.use_PRL and 1 in rel_label:
            # newest-relevant-first history expansion with (passage, query)
            # pairs (src/data.py:281-301)
            for index in range(len(rel_label) - 1, -1, -1):
                if rel_label[index] != 1:
                    continue
                rel_rec = records[i - (len(rel_label) - index)]
                if not cfg.is_PRF:
                    passage_text = rel_rec["pos_docs"][0]
                else:
                    passage_text = rel_rec["PRF_pos_docs"][0]
                rel_turn_passage = encode_no_trunc(
                    tokenizer, passage_text, cfg.max_doc_length
                )
                rel_turn_query_text = rel_rec["cur_utt_text"].strip().split(" [SEP] ")[-1]
                rel_turn_query = encode_no_trunc(
                    tokenizer, rel_turn_query_text, cfg.max_query_length
                )
                if not builder.add(rel_turn_passage):
                    break
                if not builder.add(rel_turn_query):
                    break
        else:
            # no PRL / all-zero labels / first turn: use last_response
            # (src/data.py:302-305)
            if len(last_response) > 0:
                builder.add(
                    encode_no_trunc(tokenizer, last_response, cfg.max_doc_length)
                )

        _append_history_qa(builder, ctx_utts_text, tokenizer, cfg)
        conv_qp, conv_qp_mask = builder.padded()

        example: Dict = {
            "sample_id": sample_id,
            "conv_qp": conv_qp,
            "conv_qp_mask": conv_qp_mask,
        }

        if cfg.is_train:
            pos_docs_text = record["pos_docs"][0]
            bm25_hard_neg = record["bm25_hard_neg_docs"][0]
            pos_ids = encode_trunc(tokenizer, pos_docs_text, cfg.max_doc_length)
            neg_ids = encode_trunc(tokenizer, bm25_hard_neg, cfg.max_doc_length)
            example["pos_docs"], example["pos_docs_mask"] = pad_seq_to_length(
                pos_ids, cfg.max_doc_length
            )
            example["neg_docs"], example["neg_docs_mask"] = pad_seq_to_length(
                neg_ids, cfg.max_doc_length
            )

            pseudo_texts = record.get("pseudo_prepos_docs", [])
            prepos_texts = record.get("prepos_neg_docs", [])
            # src/data.py:328-333 intent: one random previous-turn positive
            # (label 1) as pseudo-positive, one label-0 previous positive as
            # hard negative; fixed-length + presence flag here.
            if len(pseudo_texts) > 0:
                ids = encode_trunc(tokenizer, rng.choice(pseudo_texts), cfg.max_doc_length)
                example["has_pseudo_prepos"] = 1
            else:
                ids = []
                example["has_pseudo_prepos"] = 0
            example["pseudo_prepos_docs"], example["pseudo_prepos_docs_mask"] = (
                pad_seq_to_length(ids, cfg.max_doc_length)
            )
            if len(prepos_texts) > 0:
                ids = encode_trunc(tokenizer, rng.choice(prepos_texts), cfg.max_doc_length)
                example["has_prepos_neg"] = 1
            else:
                ids = []
                example["has_prepos_neg"] = 0
            example["prepos_neg_docs"], example["prepos_neg_docs_mask"] = (
                pad_seq_to_length(ids, cfg.max_doc_length)
            )
        examples.append(example)
    return examples


def build_topiocqa_train_examples_expanded(
    cfg: DataConfig,
    tokenizer,
    filename: str,
    rng: Optional[random.Random] = None,
    is_pseudo_prepos: bool = True,
) -> List[Dict]:
    """Port of the ORIGINAL Retrieval_topiocqa train path
    (src/data.py:25-199 with is_train=True): when ``is_pseudo_prepos`` is
    active, each turn additionally emits one example PER pseudo-prepos
    passage (as a positive), paired with a random bm25/prepos hard
    negative (src/data.py:160-173), followed by the standard
    gold-positive example (":187-199").  ``hard_neg_type`` selects the
    negative pool (":164-170,189-195").

    The query concat is the eval-style conv_qp of that class (PRL gating
    over (passage, query) pairs with per-segment overflow, ":64-127"),
    which the expanded example list shares across its duplicates.
    """
    rng = rng or random.Random(cfg.seed)
    data = _read_lines(filename)
    records = [json.loads(line) for line in data]
    # reuse the eval-side conv_qp construction, which follows the same code
    # path in the reference class
    base_cfg = cfg
    base = build_topiocqa_test_examples(base_cfg, tokenizer, filename)
    examples: List[Dict] = []
    for i, record in enumerate(records):
        conv = base[i]
        raw = {
            "sample_id": record["sample_id"],
            "raw_query": conv["raw_query"],
            "raw_query_mask": conv["raw_query_mask"],
            "conv_qp": conv["conv_qp"],
            "conv_qp_mask": conv["conv_qp_mask"],
        }
        bm25 = record["bm25_hard_neg_docs"]
        prepos = record.get("prepos_neg_docs", [])

        def pick_neg():
            if cfg.hard_neg_type == "prepos" and len(prepos) > 0:
                return rng.choice(prepos)
            if cfg.hard_neg_type == "prepos":
                return rng.choice(bm25)
            return rng.choice(bm25) if cfg.hard_neg_type == "bm25" else bm25[0]

        def with_docs(pos_text, neg_text):
            ex = dict(raw)
            pos_ids = encode_trunc(tokenizer, pos_text, cfg.max_doc_length)
            neg_ids = encode_trunc(tokenizer, neg_text, cfg.max_doc_length)
            ex["pos_docs"], ex["pos_docs_mask"] = pad_seq_to_length(
                pos_ids, cfg.max_doc_length
            )
            ex["neg_docs"], ex["neg_docs_mask"] = pad_seq_to_length(
                neg_ids, cfg.max_doc_length
            )
            return ex

        if getattr(cfg, "is_train", True):
            if is_pseudo_prepos:
                for pseudo in record.get("pseudo_prepos_docs", []):
                    examples.append(with_docs(pseudo, pick_neg()))
            # gold positive paired with the FIRST bm25 negative (":190")
            neg = (
                rng.choice(prepos)
                if cfg.hard_neg_type == "prepos" and len(prepos) > 0
                else bm25[0]
            )
            examples.append(with_docs(record["pos_docs"][0], neg))
        else:
            examples.append(raw)
    return examples


def build_topiocqa_test_examples(
    cfg: DataConfig,
    tokenizer,
    filename: str,
) -> List[Dict]:
    """Port of the eval path of Retrieval_topiocqa (src/data.py:25-199)
    with is_train=False.

    Produces ``raw_query`` (padded bare current query) and ``conv_qp``:
      * use_PRL and 1 in rel_label: label-1 prior turns' (pos passage,
        query), newest first (src/data.py:64-96);
      * not use_PRL: ALL prior turns' (pos passage, query), newest first —
        no label gating (src/data.py:97-127), the published convqp eval
        input;
      * then the Q/A history loop (src/data.py:129-148); TopiOCQA test
        records carry no ctx turns, so it is usually a no-op.
    """
    data = _read_lines(filename)
    records = [json.loads(line) for line in data]
    examples: List[Dict] = []

    for i, record in enumerate(records):
        sample_id = record["sample_id"]
        ctx_utts_text, cur_utt_text = _split_history(record["cur_utt_text"])
        rel_label = record["rel_label"]

        cur_utt = encode_no_trunc(tokenizer, cur_utt_text, cfg.max_query_length)
        builder = ConcatBuilder(cfg.max_concat_length)
        builder.ids.extend(cur_utt)

        def _add_turn(index: int) -> bool:
            rel_rec = records[i - (len(rel_label) - index)]
            if not cfg.is_PRF:
                passage = encode_no_trunc(
                    tokenizer, rel_rec["pos_docs"][0], cfg.max_doc_length
                )
                if not builder.add(passage):
                    return False
            else:
                for p_i, passage_text in enumerate(rel_rec["PRF_pos_docs"]):
                    if p_i >= cfg.PRF_top:
                        break
                    passage = encode_no_trunc(tokenizer, passage_text, cfg.max_doc_length)
                    if not builder.add(passage):
                        return False
            query_text = rel_rec["cur_utt_text"].strip().split(" [SEP] ")[-1]
            query = encode_no_trunc(tokenizer, query_text, cfg.max_query_length)
            return builder.add(query)

        if cfg.use_PRL and 1 in rel_label:
            for index in range(len(rel_label) - 1, -1, -1):
                if rel_label[index] == 1:
                    if not _add_turn(index):
                        break
        elif not cfg.use_PRL:
            for index in range(len(rel_label) - 1, -1, -1):
                if not _add_turn(index):
                    break

        _append_history_qa(builder, ctx_utts_text, tokenizer, cfg)

        raw_query, raw_query_mask = pad_seq_to_length(cur_utt, cfg.max_query_length)
        conv_qp, conv_qp_mask = builder.padded()
        examples.append(
            {
                "sample_id": sample_id,
                "raw_query": raw_query,
                "raw_query_mask": raw_query_mask,
                "conv_qp": conv_qp,
                "conv_qp_mask": conv_qp_mask,
            }
        )
    return examples
