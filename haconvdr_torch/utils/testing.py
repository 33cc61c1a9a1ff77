"""Stateless word-hash tokenizer for tests and for driving the serving path
where no HF tokenizer is installed, a stand-in ``transformers`` module
that hands it out, and offline tokenizer files and tiny HF checkpoints
for the real tokenizers.

Implements the subset of the HF tokenizer protocol that
``haconvdr_torch.data.sequence`` uses (``encode`` with
``add_special_tokens`` / ``max_length`` / ``truncation``, special-token
ids).  RoBERTa's special ids: ``<s>`` = 0, ``<pad>`` = 1, ``</s>`` = 2;
words hash (crc32) into [5, vocab_size), so any vocabulary size works and
two instances always agree.  Like ``FakeTokenizer``, ``encode`` truncates
only when ``truncation=True`` (transformers>=3 semantics).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import List, Optional


class HashTokenizer:
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

    def encode(
        self,
        text: str,
        add_special_tokens: bool = True,
        max_length: Optional[int] = None,
        truncation: bool = False,
    ) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        if truncation and max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_token_id]
        return ids


def hash_tokenizer_transformers(vocab_size: int = 50265):
    """A stand-in ``transformers`` module for checkpoints with random weights
    and no tokenizer files, or a machine without ``transformers``: its
    ``RobertaTokenizer`` and ``BertTokenizer`` ``.from_pretrained(path,
    ...)`` return ``HashTokenizer(vocab_size)``, so ``hf_import.load_model``
    and ``serve.Retriever.load`` run unchanged.  The caller registers it in
    ``sys.modules["transformers"]`` and removes it afterwards."""
    import types

    class _Factory:
        @staticmethod
        def from_pretrained(path, **kw):
            return HashTokenizer(vocab_size)

    mod = types.ModuleType("transformers")
    mod.RobertaTokenizer = mod.BertTokenizer = _Factory
    return mod


def _byte_symbols() -> List[str]:
    """GPT-2's byte-level alphabet, in its order: the printable bytes stand
    for themselves, the other bytes map to code points from 256 on."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("\xa1"), ord("\xac") + 1),
            *range(ord("\xae"), ord("\xff") + 1)]
    rest = [b for b in range(256) if b not in keep]
    return [chr(b) for b in keep] + [chr(256 + n) for n in range(len(rest))]


def write_tokenizer_files(out: str, model_type: str = "ANCE") -> int:
    """Offline tokenizer files in the directory ``out`` (no download): a
    byte-level BPE ``vocab.json`` (RoBERTa's five specials, every byte,
    then the results of its two merges, which newer ``transformers``
    requires) with a two-merge ``merges.txt``, or for a ``"BERT*"`` model
    type a word-piece ``vocab.txt`` of printable ASCII.  Returns the
    vocabulary's size.  Needs no ``transformers``."""
    os.makedirs(out, exist_ok=True)
    if model_type.upper().startswith("BERT"):
        words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        words += [chr(c) for c in range(33, 127)] + ["##" + chr(c) for c in range(97, 123)]
        with open(os.path.join(out, "vocab.txt"), "w") as f:
            f.write("\n".join(words) + "\n")
        return len(words)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    for sym in _byte_symbols() + ["th", "the"]:  # each merge's result is a token too
        vocab.setdefault(sym, len(vocab))
    with open(os.path.join(out, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(out, "merges.txt"), "w") as f:
        f.write("#version: 0.2\nt h\nth e\n")
    return len(vocab)


def write_tiny_hf_checkpoint(out: str, model_type: str = "ANCE", seed: int = 0, **cfg_kw) -> str:
    """An HF checkpoint directory ``out`` that ``hf_import.load_model``
    reads offline: ``write_tokenizer_files``, then ``ModelConfig.tiny``
    weights from ``init_params_numpy(cfg, seed)`` saved by
    ``save_hf_checkpoint``.  The vocabulary is the tokenizer's plus 8 ids;
    ``cfg_kw`` overrides tiny's other fields (positions default to 520)."""
    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.hf_import import save_hf_checkpoint

    n = write_tokenizer_files(out, model_type)
    cfg = ModelConfig.tiny(**{"model_type": model_type, "vocab_size": n + 8,
                              "max_position_embeddings": 520, **cfg_kw})
    save_hf_checkpoint(init_params_numpy(cfg, seed=seed), cfg, str(out))
    return str(out)
