"""The one generator every mix is drawn with; a mix is its parameters
(``traffic/<name>.json``).

Sessions (``"sessions"``): request j is turn t of a conversation: the
question and t - 1 earlier turns (question, answer, and a history passage
on a share of the turns), words drawn from a vocabulary of ``words``
tokens ``w0 .. w{words-1}`` (one token each under the stand-in
tokenizer).  The sizes (turns and word counts) form a fixed pool drawn
from the mix's own ``pool_seed``, so every run seed sends the same sizes:
the seed orders the pool and draws the words.

Arrivals (``"rate"``, open loop): ``round(rate x seconds)`` arrival times
in the window, a Poisson process conditioned on its count, drawn with
``pool_seed`` alone: every seed offers the same arrivals (bursts
included), and the seed decides which request comes at each.

Corpus (``"corpus"``): passages of ``length`` [lo, hi] tokens (``<s>``,
ids, ``</s>``, padded with 0 to ``max_seq_length``); lengths from the
fixed pool, ids from the run seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(k) for k in key]))


class Sessions:
    """Conversational requests of a mix: ``request(j)`` ->
    (question, ((question, answer), ...) oldest first, (passage or "", ...)):
    tuples of strings only, which the garbage collector stops tracking, so
    requests held through a window add no work to its collections."""

    def __init__(self, mix: Dict, seed: int):
        s = mix["sessions"]
        self.seed = int(seed)
        self.words = int(s["words"])
        self._vocab = np.array([f"w{i}" for i in range(self.words)], dtype=object)
        pool = int(s["pool"])
        r = _rng(s["pool_seed"])
        lo, hi = s["turns"]
        self.turns = r.integers(lo, hi + 1, pool)
        self.sizes = []  # per pool entry: [question words, (q, a, passage) words per turn]
        for t in self.turns:
            qw = int(r.integers(s["question_words"][0], s["question_words"][1] + 1))
            hist = []
            for _ in range(int(t) - 1):
                hq = int(r.integers(s["question_words"][0], s["question_words"][1] + 1))
                ha = int(r.integers(s["answer_words"][0], s["answer_words"][1] + 1))
                hp = (int(r.integers(s["passage_words"][0], s["passage_words"][1] + 1))
                      if r.random() < s["passage_share"] else 0)
                hist.append((hq, ha, hp))
            self.sizes.append((qw, hist))
        self.pool = pool
        self._order = {}  # cycle -> its permutation of the pool

    def _entry(self, j: int) -> int:
        cycle, at = divmod(int(j), self.pool)
        if cycle not in self._order:
            self._order[cycle] = _rng(self.seed, 1, cycle).permutation(self.pool)
        return int(self._order[cycle][at])

    def words_of(self, j: int) -> int:
        """Words request j carries (its size before tokenizing)."""
        qw, hist = self.sizes[self._entry(j)]
        return qw + sum(a + b + c for a, b, c in hist)

    def request(self, j: int) -> Tuple[str, Tuple[Tuple[str, str], ...], Tuple[str, ...]]:
        qw, hist = self.sizes[self._entry(j)]
        r = _rng(self.seed, 2, j)
        text = self._vocab[r.integers(0, self.words, qw + sum(a + b + c for a, b, c in hist))]
        at = 0

        def take(n):
            nonlocal at
            at += n
            return " ".join(text[at - n:at])

        question = take(qw)
        history, passages = [], []
        for hq, ha, hp in hist:
            history.append((take(hq), take(ha)))
            passages.append(take(hp) if hp else "")
        return question, tuple(history), tuple(passages)


def arrivals(mix: Dict, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of an open loop's requests."""
    n = int(round(mix["rate"] * seconds))
    gaps = _rng(mix["sessions"]["pool_seed"], 3, n).exponential(1.0, n + 1)
    return np.cumsum(gaps)[:n] * (seconds / gaps.sum())


CHUNK = 4096  # passages drawn together


class Corpus:
    """Tokenized passages of a mix: ``lengths`` [n] and ``ids(a, b)``."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        c = mix["corpus"]
        self.n, self.L, self.seed, self.vocab = int(c["passages"]), int(c["max_seq_length"]), \
            int(seed), int(vocab)
        lo, hi = c["length"]
        pool = _rng(c["pool_seed"]).integers(lo, hi + 1, self.n).astype(np.int32)
        self.lengths = pool[_rng(seed, 4).permutation(self.n)]

    def ids(self, a: int, b: int) -> np.ndarray:
        """[b - a, L] int32 token ids of passages a..b-1 (drawn CHUNK
        passages at a time, so a passage's ids do not depend on a, b)."""
        parts = []
        for c in range(a // CHUNK, (b - 1) // CHUNK + 1):
            lo, hi = max(a, c * CHUNK), min(b, (c + 1) * CHUNK)
            chunk = _rng(self.seed, 5, c).integers(5, self.vocab, (CHUNK, self.L))
            parts.append(chunk[lo - c * CHUNK:hi - c * CHUNK])
        ids = np.concatenate(parts).astype(np.int32)
        ln = self.lengths[a:b]
        ids[:, 0] = 0
        ids[np.arange(b - a), ln - 1] = 2
        ids[np.arange(self.L)[None, :] >= ln[:, None]] = 0
        return ids

    def ids_of(self, picked) -> np.ndarray:
        """[len(picked), L] int32 token ids of the passages ``picked``."""
        out = np.zeros((len(picked), self.L), np.int32)
        by_chunk = {}
        for m, j in enumerate(picked):
            by_chunk.setdefault(int(j) // CHUNK, []).append((m, int(j)))
        for c, items in by_chunk.items():
            lo, hi = c * CHUNK, min(self.n, (c + 1) * CHUNK)
            block = self.ids(lo, hi)
            for m, j in items:
                out[m] = block[j - lo]
        return out

