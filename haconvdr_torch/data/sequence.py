"""Token-sequence construction primitives.

Reproduces the reference's conversation-concat semantics exactly — these
quirks silently define what the model sees (SURVEY.md SS7 hard part (c)):

  * ``padding_seq_to_same_length`` (src/data.py:8-23): right-pad with 0,
    or hard-truncate to the max length with an all-ones mask;
  * the "must end with [SEP]" truncation rule (src/data.py:292-299 etc.):
    when appending a segment would exceed ``max_concat_length``, append
    ``segment[:budget-1] + [segment[-1]]`` and stop.

Tokenizer protocol: any object with ``encode(text, add_special_tokens=...,
max_length=..., truncation=...)`` plus ``cls_token_id`` / ``sep_token_id``
attributes (HF tokenizers satisfy this; tests use a deterministic fake).
Note the reference calls ``encode`` for the current query WITHOUT
``truncation=True`` (src/data.py:279), which under transformers>=3 does NOT
truncate — we mirror that call-for-call.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def pad_seq_to_length(
    input_ids: Sequence[int], max_pad_length: int, pad_token: int = 0
) -> Tuple[List[int], List[int]]:
    """Pad/truncate to a fixed length; returns (ids, attention_mask).

    Mirrors padding_seq_to_same_length (src/data.py:8-23) including its
    truncation branch where the mask is all ones.
    """
    input_ids = list(input_ids)
    padding_length = max_pad_length - len(input_ids)
    if padding_length <= 0:
        return input_ids[:max_pad_length], [1] * max_pad_length
    return (
        input_ids + [pad_token] * padding_length,
        [1] * len(input_ids) + [0] * padding_length,
    )


class ConcatBuilder:
    """Accumulates tokenized segments under the reference truncation rule.

    ``add`` returns False once the budget is exhausted (after emitting the
    truncated tail ending in the segment's final token, the forced-[SEP]
    rule of src/data.py:292-299); callers must stop appending then.
    """

    def __init__(self, max_length: int):
        self.max_length = max_length
        self.ids: List[int] = []
        self.full = False

    def add(self, segment: Sequence[int]) -> bool:
        if self.full:
            return False
        segment = list(segment)
        if len(self.ids) + len(segment) > self.max_length:
            budget = self.max_length - len(self.ids) - 1
            # budget can be negative when ids is already at/over max; the
            # reference slice semantics then keep only the trailing [SEP].
            self.ids += segment[:budget] + [segment[-1]]
            self.full = True
            return False
        self.ids.extend(segment)
        return True

    def padded(self, pad_token: int = 0) -> Tuple[List[int], List[int]]:
        return pad_seq_to_length(self.ids, self.max_length, pad_token)


def encode_trunc(tokenizer, text: str, max_length: int) -> List[int]:
    """tokenizer.encode(..., truncation=True) — used for history turns and
    documents (src/data.py:312, 324-333)."""
    return list(
        tokenizer.encode(
            text, add_special_tokens=True, max_length=max_length, truncation=True
        )
    )


def encode_no_trunc(tokenizer, text: str, max_length: int) -> List[int]:
    """tokenizer.encode(..., max_length=...) without truncation — modern
    transformers does NOT truncate here; mirrors src/data.py:279."""
    return list(
        tokenizer.encode(text, add_special_tokens=True, max_length=max_length)
    )
