"""PRJ (pseudo relevance judgment) probe dataset builders.

The PRJ pass scores each history turn's usefulness by running retrieval on
probe queries: probe ``conv-turn-0`` is the bare current query, probe
``conv-turn-k`` is the query paired with history query k (SURVEY.md SS2 #5,
#17).  Probe files are produced by preprocess/prj.py (reference
preprocess/PRJ_topiocqa.py:238-300).

This module rebuilds the probe Dataset classes:
  * ``ConvDataset_topiocqa_rel`` (src/data.py:887-1010)
  * ``ConvDataset_qrecc_rel`` (src/data.py:1026-1137)

Both reference classes are riddled with NameErrors on their optional
branches (undefined ``last_response`` / ``history_answer`` at
src/data.py:923,933; undefined ``pad_seq_ids_with_mask`` at :985).  Here
the intended behavior is implemented: pair_query = cur_query [+ <response>
last_response] [+ last history answer] [+ history query k], padded to
``max_concat_length`` (pads beyond it are hard-truncated by the padding
helper, matching padding_seq_to_same_length semantics).
"""

from __future__ import annotations

import json
import random
from typing import Dict, List

from haconvdr_torch.config import DataConfig
from haconvdr_torch.data.sequence import encode_no_trunc, pad_seq_to_length


def _last_response_segment(tokenizer, last_response: str, max_doc_length: int) -> List[int]:
    """[CLS] <response> tokens(last_response)[:max_doc_length] [SEP]
    (src/data.py:924-929)."""
    lp = [tokenizer.cls_token_id]
    lp.extend(tokenizer.convert_tokens_to_ids(["<response>"]))
    lp.extend(tokenizer.convert_tokens_to_ids(tokenizer.tokenize(last_response)))
    lp = lp[: max_doc_length]
    lp.append(tokenizer.sep_token_id)
    return lp


def build_prj_probe_examples(
    cfg: DataConfig,
    tokenizer,
    filename: str,
    use_last_response: bool = False,
    use_answer: bool = False,
    use_data_percent: float = 1.0,
    seed: int = 42,
) -> List[Dict]:
    """Probe records -> padded ``pair_query`` examples.

    Input records come from create_label_rel_turn output
    (preprocess/PRJ_topiocqa.py:261-298): fields id, conv_id, turn_id,
    query, query_pair (empty for the base probe), last_response,
    history_answer (topiocqa only).
    """
    with open(filename, encoding="utf-8") as f:
        lines = [l for l in f if l.strip()]
    n = int(use_data_percent * len(lines))
    if n < len(lines):
        lines = random.Random(seed).sample(lines, n)

    examples: List[Dict] = []
    for line in lines:
        record = json.loads(line)
        query = record["query"]
        query_pair = record["query_pair"]

        pair_query: List[int] = list(encode_no_trunc(tokenizer, query, cfg.max_query_length))
        if use_last_response and len(record.get("last_response", "")) > 0:
            pair_query.extend(
                _last_response_segment(
                    tokenizer, record["last_response"], cfg.max_doc_length
                )
            )
        if use_answer and len(record.get("history_answer", [])) > 0:
            pair_query.extend(
                encode_no_trunc(
                    tokenizer, record["history_answer"][-1], cfg.max_response_length
                )
            )
        if len(query_pair) > 0:
            pair_query.extend(
                encode_no_trunc(tokenizer, query_pair, cfg.max_query_length)
            )

        ids, mask = pad_seq_to_length(pair_query, cfg.max_concat_length)
        examples.append(
            {
                "sample_id": record["id"],
                "conv_id": record["conv_id"],
                "turn_id": record["turn_id"],
                "pair_query": ids,
                "pair_query_mask": mask,
            }
        )
    return examples
