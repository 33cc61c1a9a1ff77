"""The stand-in tokenizer both sides are handed: words split on white
space and hashed (crc32) into [5, vocab_size); RoBERTa's special ids
``<s>`` = 0, ``<pad>`` = 1, ``</s>`` = 2.  ``encode`` truncates only with
``truncation=True`` (transformers>=3 semantics), as the real one does."""

from __future__ import annotations

import zlib
from typing import List, Optional


class HashWordTokenizer:
    cls_token_id = 0
    pad_token_id = 1
    sep_token_id = 2
    unk_token_id = 3
    first_word_id = 5

    def __init__(self, vocab_size: int = 50265):
        if vocab_size <= self.first_word_id:
            raise ValueError(f"vocab_size must exceed {self.first_word_id}")
        self.vocab_size = vocab_size

    def tokenize(self, text: str) -> List[str]:
        return text.split()

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        span = self.vocab_size - self.first_word_id
        return [self.first_word_id + zlib.crc32(t.encode()) % span for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None, truncation: bool = False) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        if truncation and max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_token_id]
        return ids
