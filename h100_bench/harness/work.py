"""The work each layer's inputs need, whatever implements it.

The tower counts each real request's valid tokens l only: 2 x (dense
parameters) x l for the transformer's dense layers, 4 x l^2 x hidden x
layers for attention (QK^T and PV), and the head on one row.  Padding to
the batch's length and a bucket's copies of its first row are not work,
so a length-aware tower raises the share and no tower can pass 100%.
Bytes: the dense weights read once a call.  The search counts 2 x Q_real
x N x D operations at the index's precision and the index's bytes once a
call.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable

ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


class Work:
    """Operations by precision and bytes moved."""

    def __init__(self, ops: Dict[str, float] = None, nbytes: float = 0.0):
        self.ops = defaultdict(float, ops or {})
        self.nbytes = float(nbytes)

    def add(self, other: "Work") -> "Work":
        for p, n in other.ops.items():
            self.ops[p] += n
        self.nbytes += other.nbytes
        return self

    def least_seconds(self) -> float:
        from h100_bench.harness.peaks import least_seconds

        return least_seconds(dict(self.ops), self.nbytes)


def dense_params(model: Dict) -> int:
    """Parameters of the transformer layers' dense kernels."""
    H, I = model["hidden_size"], model["intermediate_size"]
    return model["num_hidden_layers"] * (4 * H * H + 2 * H * I)


def tower_work(lengths: Iterable[int], model: Dict, tower: Dict) -> Work:
    """One call of the tower over requests of these valid lengths.
    ``tower``: ``dense`` / ``attention`` / ``head`` precisions and the
    bytes of one dense weight (``weight_bytes``)."""
    H, E, nl = model["hidden_size"], model["embedding_dim"], model["num_hidden_layers"]
    P = dense_params(model)
    w = Work(nbytes=P * tower["weight_bytes"])
    for n in lengths:
        w.ops[tower["dense"]] += 2.0 * P * n
        w.ops[tower["attention"]] += 4.0 * n * n * H * nl
        w.ops[tower["head"]] += 2.0 * H * E
    return w


def search_work(q_real: int, rows: int, dim: int, dtype: str, k: int) -> Work:
    """One search of ``q_real`` real queries over the index."""
    return Work({dtype: 2.0 * q_real * rows * dim},
                rows * dim * ELEMENT_BYTES[dtype] + q_real * (dim * 4 + k * 8))
