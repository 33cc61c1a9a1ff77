"""The reference at a configuration's precision, or its control one step
below: float32 with TF32 off (control: TF32 on), int8 (control: int4).

``Reference(config, params, device, control)`` holds the tower's weights
on the device; ``embed(ids, mask)`` runs it in blocks of rows, and
``index(rows)`` builds the exact search over the index rows.
"""

from __future__ import annotations

from typing import Dict

import torch

from h100_bench.reference import ance
from h100_bench.reference.search import Index

LEVELS = {"int8": 127}
CONTROL_LEVELS = {"int8": 7}
BLOCK_ROWS = 32  # sequences a forward pass


class Reference:
    def __init__(self, config: Dict, params: Dict, device, control: bool = False):
        self.precision = config["precision"]
        self.control = control
        self.heads = config["num_attention_heads"]
        self.eps = config["layer_norm_eps"]
        P = ance.to_device(params, device)
        if self.precision == "float32":
            self.levels = None
        elif self.precision in LEVELS:
            self.levels = (CONTROL_LEVELS if control else LEVELS)[self.precision]
            P = ance.int_params(P, self.levels)
        else:
            raise ValueError(f"no reference for precision {self.precision!r}")
        self.P = P
        self.device = device

    def _tf32(self):
        return ance.tf32(self.control and self.levels is None)

    @torch.inference_mode()
    def embed(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        out = []
        with self._tf32():
            for a in range(0, ids.shape[0], BLOCK_ROWS):
                i = ids[a:a + BLOCK_ROWS].to(self.device)
                m = mask[a:a + BLOCK_ROWS].to(self.device)
                if self.levels is None:
                    out.append(ance.forward_f32(self.P, i, m, self.heads, self.eps))
                else:
                    out.append(ance.forward_int(self.P, i, m, self.levels, self.heads, self.eps))
        return torch.cat(out)

    def index(self, rows: torch.Tensor) -> "ReferenceIndex":
        return ReferenceIndex(Index(rows, self.levels), self._tf32)


class ReferenceIndex:
    """``Index`` with the reference's TF32 setting around each search."""

    def __init__(self, index: Index, tf32):
        self._index, self._tf32 = index, tf32

    @torch.inference_mode()
    def topk(self, q, k):
        with self._tf32():
            return self._index.topk(q, k)

    @torch.inference_mode()
    def scores_at(self, q, ids):
        with self._tf32():
            return self._index.scores_at(q, ids)
