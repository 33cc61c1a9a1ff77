"""The numbers that decide ``correct``, and their limits.

Serving: for each sampled request, the reference's embedding of the
request's own text, its exact top k over the whole index (T, descending)
and its scores of the k served rows (S):

* ``rank_gap``: max over ranks r of (T_r - S_r) / |T_1|: how far below the
  reference's r-th best the served r-th passage lies (0 when the served
  list is the reference's; a wrong, missing or misplaced passage makes it
  large; near-ties swapped read as rounding);
* ``score_err``: max over ranks of |served score - S_r| / |T_1|;
* ``missing``: requests of the window that never got an answer, or got
  fewer than k passages (limit 0).

Encode: ``row_err``, max over sampled passages of |stored row
(codes x block scale) - reference row| / |reference row|, and
``offsets_wrong``, stored row offsets that are not 0, 1, ... in order
(limit 0).  A number that is not finite fails.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def served_numbers(index, q_ref: torch.Tensor, served: Sequence[Tuple[np.ndarray, np.ndarray]],
                   k: int) -> Dict[str, float]:
    """``served``: per sampled request (row ids [<=k] int64, scores [<=k])
    in served order; a row id < 0 marks a passage id that maps to no row."""
    T, _ = index.topk(q_ref, k)
    M = len(served)
    ids = torch.zeros((M, k), dtype=torch.int64)
    sc = torch.zeros((M, k), dtype=torch.float64)
    bad = torch.zeros((M, k), dtype=torch.bool)
    for m, (i, s) in enumerate(served):
        n = min(len(i), k)
        ids[m, :n] = torch.as_tensor(np.asarray(i[:n], np.int64))
        sc[m, :n] = torch.as_tensor(np.asarray(s[:n], np.float64))
        bad[m, n:] = True
    bad |= ids < 0
    dev = q_ref.device
    S = index.scores_at(q_ref, ids.clamp_min(0).to(dev)).double().cpu()
    T = T.double().cpu()
    scale = T[:, :1].abs().clamp_min(1e-30)
    gap = (T - S) / scale
    err = (sc - S).abs() / scale
    gap[bad] = math.inf
    err[bad] = math.inf
    return {"rank_gap": float(gap.max()), "score_err": float(err.max())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number finite and at most its limit, {name: {value, limit}})."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits[name]
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if value is None or math.isfinite(value) else None,
                        "limit": limit}
    return ok, checks


def sample(seed: int, candidates: List[int], size: int, longest: int) -> List[int]:
    """``size`` of ``candidates`` drawn from the seed, ``longest`` among them."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 9]))
    rest = [c for c in candidates if c != longest]
    pick = rng.choice(len(rest), min(size - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in sorted(pick)]
