"""TREC-CAST evaluation dataset builder.

Reimplements ``Test_Retrieval_cast`` (src/data.py:648-743): per record the
bare query concat (``conv_q``) and a response-augmented concat
(``conv_qp``).  CAST records carry ``input`` = [q1..qk], ``topic_number``,
``query_number``; for topics > 80 the prior turns' ``manual_response`` (a
random one) is interleaved before each history query (src/data.py:678-698).
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional

from haconvdr_torch.config import DataConfig
from haconvdr_torch.data.sequence import ConcatBuilder, encode_no_trunc, encode_trunc


def build_cast_test_examples(
    cfg: DataConfig,
    tokenizer,
    filename: str,
    rng: Optional[random.Random] = None,
) -> List[Dict]:
    rng = rng or random.Random(cfg.seed)
    with open(filename, encoding="utf-8") as f:
        records = [json.loads(line) for line in f if line.strip()]

    examples: List[Dict] = []
    for i, record in enumerate(records):
        sample_id = record["id"]
        conv_id = record["topic_number"]
        cur_utt_text = record["input"][-1]
        ctx_utts_text = record["input"][:-1]

        cur_utt = encode_no_trunc(tokenizer, cur_utt_text, cfg.max_query_length)
        q_builder = ConcatBuilder(cfg.max_concat_length)
        qp_builder = ConcatBuilder(cfg.max_concat_length)
        q_builder.ids.extend(cur_utt)
        qp_builder.ids.extend(cur_utt)

        for j in range(len(ctx_utts_text) - 1, -1, -1):
            prior = records[i - (len(ctx_utts_text) - j)]
            if int(conv_id) > 80 and len(prior.get("manual_response", [])) > 0:
                passage = encode_no_trunc(
                    tokenizer, rng.choice(prior["manual_response"]), cfg.max_doc_length
                )
                if not qp_builder.add(passage):
                    break
            utt = encode_trunc(tokenizer, ctx_utts_text[j], cfg.max_query_length)
            if not q_builder.add(utt):
                break
            if not qp_builder.add(utt):
                break

        conv_q, conv_q_mask = q_builder.padded()
        conv_qp, conv_qp_mask = qp_builder.padded()
        examples.append(
            {
                "sample_id": sample_id,
                "conv_q": conv_q,
                "conv_q_mask": conv_q_mask,
                "conv_qp": conv_qp,
                "conv_qp_mask": conv_qp_mask,
            }
        )
    return examples
