"""Exact inner-product search over the whole index, in plain PyTorch.

* float32: scores ``q . p`` of float32 rows (TF32 is the caller's
  switch), the top k by ``torch.topk``, row block by row block.
* int codes (``levels`` 127: int8, 7: int4): each dimension of the index
  coded with ``max|p[:, d]| / levels`` (1 for an all-zero dimension); a
  query is folded with those scales, coded per query (``round(f /
  max|f| x levels)``), scored with exact integer sums and dequantized as
  ``sum x (max|f| / levels)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BLOCK = 262_144  # index rows a pass: bounds the [Q, BLOCK] score temporaries


def index_codes(rows: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 [N, D], per-dimension scale [D] float32)."""
    amax = torch.zeros(rows.shape[1], dtype=torch.float32, device=rows.device)
    for a in range(0, rows.shape[0], BLOCK):
        amax = torch.maximum(amax, rows[a:a + BLOCK].to(torch.float32).abs().amax(0))
    # a tensor divisor: CUDA divides by a Python scalar as a product by its
    # reciprocal, an ulp off an IEEE division at some values
    scale = torch.where(amax > 0, amax / torch.full_like(amax, levels), torch.ones_like(amax))
    codes = torch.empty(rows.shape, dtype=torch.int8, device=rows.device)
    for a in range(0, rows.shape[0], BLOCK):
        x = rows[a:a + BLOCK].to(torch.float32) / scale
        codes[a:a + BLOCK] = torch.clamp(torch.round(x), -levels, levels).to(torch.int8)
    return codes, scale


class Index:
    """The reference's view of the index: float32 rows, or int codes."""

    def __init__(self, rows: torch.Tensor, levels: Optional[int] = None):
        self.levels = levels
        if levels is None:
            self.rows, self.scale = rows, None
        else:
            self.rows, self.scale = index_codes(rows, levels)

    def _queries(self, q: torch.Tensor):
        """(float32 query operands, per-query dequantization [Q, 1] or None)."""
        q = q.to(torch.float32)
        if self.levels is None:
            return q, None
        f = q * self.scale
        s = torch.clamp_min(f.abs().amax(-1, keepdim=True), 1e-30)
        return torch.clamp(torch.round(f / s * self.levels), -self.levels, self.levels), \
            s / self.levels

    def _block(self, a: int, b: int) -> torch.Tensor:
        # int codes of at most 127 x 127 x 768 sum exactly in float32
        return self.rows[a:b].to(torch.float32)

    def topk(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k] descending, row ids [Q, k] int64)."""
        qf, deq = self._queries(q)
        best_s = best_i = None
        for a in range(0, self.rows.shape[0], BLOCK):
            s = qf @ self._block(a, a + BLOCK).T
            if deq is not None:
                s = s * deq
            s, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            i = i + a
            if best_s is not None:
                s, j = torch.topk(torch.cat([best_s, s], 1), k, dim=1)
                i = torch.gather(torch.cat([best_i, i], 1), 1, j)
            best_s, best_i = s, i
        return best_s, best_i

    def scores_at(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Scores [Q, k] of query q[j] against rows ids[j] (ids >= 0)."""
        qf, deq = self._queries(q)
        p = self.rows[ids].to(torch.float32)  # [Q, k, D]
        s = torch.bmm(p, qf[:, :, None])[:, :, 0]
        return s if deq is None else s * deq
