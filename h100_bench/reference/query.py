"""HAConvDR's convqp query, rebuilt from a request's text: the question,
then the earlier turns newest first (passage, answer, question), each
segment encoded with its special tokens and without truncation.  A
segment that would overflow ``max_concat`` is cut to its first
``budget - 1`` tokens plus its last token, and nothing follows it (the
reference's forced-[SEP] rule, src/data.py:292-299).  Padded with 0."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def convqp_ids(tokenizer, question: str, history: Sequence[Tuple[str, str]],
               passages: Sequence[str], max_concat: int = 512) -> Tuple[List[int], int]:
    """(ids padded to ``max_concat``, number of valid tokens)."""
    ids: List[int] = []

    def add(segment: List[int]) -> bool:
        if len(ids) + len(segment) > max_concat:
            budget = max_concat - len(ids) - 1
            ids.extend(segment[:budget] + [segment[-1]])
            return False
        ids.extend(segment)
        return True

    ids.extend(tokenizer.encode(question, add_special_tokens=True))
    for t in range(len(history) - 1, -1, -1):
        if t < len(passages) and passages[t]:
            if not add(tokenizer.encode(passages[t], add_special_tokens=True)):
                break
        q, a = history[t]
        if a and not add(tokenizer.encode(a, add_special_tokens=True)):
            break
        if not add(tokenizer.encode(q, add_special_tokens=True)):
            break
    n = min(len(ids), max_concat)
    ids = ids[:max_concat]
    return ids + [0] * (max_concat - n), n
