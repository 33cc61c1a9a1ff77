"""Batching utilities: python example dicts -> fixed-shape numpy batches.

Replaces the reference's DataLoader + per-dataset collate_fns
(src/data.py:343-379 etc.).  TPU-first differences:
  * every batch has the SAME static shape — the ragged final batch is
    padded up to ``batch_size`` and flagged via ``valid`` (jit compiles
    once, no shape-polymorphic recompiles);
  * non-tensor fields (sample ids) are carried as python lists.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_STR_KEYS = ("sample_id", "conv_id", "turn_id")


def collate(examples: Sequence[Dict], pad_to: Optional[int] = None) -> Dict:
    """Stack a list of example dicts into a batch dict of int32 arrays.

    ``pad_to``: pad the batch up to this many rows by repeating the first
    example with valid=0.
    """
    n = len(examples)
    assert n > 0
    total = pad_to or n
    valid = np.zeros((total,), np.int32)
    valid[:n] = 1
    rows = list(examples) + [examples[0]] * (total - n)

    batch: Dict = {"valid": valid}
    for key in rows[0]:
        if key in _STR_KEYS:
            batch[key] = [r[key] for r in rows]
        else:
            batch[key] = np.asarray([r[key] for r in rows], np.int32)
    return batch


def batch_iter(
    examples: Sequence[Dict],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 42,
    drop_last: bool = False,
) -> Iterator[Dict]:
    order = list(range(len(examples)))
    if shuffle:
        random.Random(seed).shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate([examples[i] for i in idx], pad_to=batch_size)


def num_batches(n_examples: int, batch_size: int) -> int:
    """ceil-division step count (src/train_HAConvDR_topiocqa.py:103)."""
    return n_examples // batch_size + int(bool(n_examples % batch_size))
