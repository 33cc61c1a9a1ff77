"""Exact second-stage rescoring for quantized first-stage search.

int8 residency is a CAPACITY format: per-dim uniform codes carry an
irreducible score noise that accumulates over the 768 dims (std
~|q|*step*sqrt(D/12)), and on low-effective-rank encoder manifolds that
noise exceeds the true neighbor score gaps — measured on the 1M
real-geometry matrix (.probe_int8_err.py): int8-vs-exact recall@100 is
0.86 flat / 0.68 IVF-residual, while the bf16 path is lossless (the
encoder emits bf16-native embeddings).  The standard production answer
is two-stage serving: scan the int8-resident index for an OVERSAMPLED
candidate set, then exactly rescore just those rows from the float
block store on the host.  Measured on the same matrix: the true top-100
is 99.9% contained in the int8 top-300 and 100% in the top-500, so a
3-5x oversample restores exact quality at int8 HBM cost.

The rescore gather reads ``Q * m`` rows from the mmap'd store (~1.5 MB
per query at m=500, bf16) and the rerank matmul is ``Q x m x D`` — host
work, microseconds; no device round-trip.

Reference scope: beyond the reference (faiss-gpu serves f32 flat only,
src/test_HAConvDR_topiocqa.py:74-162).  The scheme is the IVF-SQ +
refine ("RFlat") pattern from the faiss family, built TPU-first: the
accelerator does the bandwidth-bound coarse scan, the host does the
latency-trivial exact fix-up.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np

from haconvdr_torch.index.store import EmbeddingBlockStore

logger = logging.getLogger(__name__)


class StoreRescorer:
    """Global-id -> exact-row gather over an EmbeddingBlockStore, plus
    the top-k rerank.  Builds a per-block id locator once: the common
    case (generator-written stores) is one contiguous arange per block,
    kept as (start, stop) ranges; anything else falls back to a sorted
    global index (searchsorted at gather time)."""

    def __init__(self, store: EmbeddingBlockStore):
        self.store = store
        self._blocks: List[np.ndarray] = []  # mmap'd [N_b, D] float rows
        self._ranges: Optional[List[Tuple[int, int]]] = []
        all_ids, all_loc = [], []
        for b in range(store.num_blocks()):
            emb, ids = store.read_block(b)  # emb stays mmap'd
            if emb.dtype == np.int8:
                raise ValueError(
                    "StoreRescorer needs a float block store (the disk copy "
                    f"should stay bf16/f32; block {b} is int8 — int8 belongs "
                    "in HBM, not in the rescore source)"
                )
            self._blocks.append(emb)
            ids = np.asarray(ids, np.int64)
            if self._ranges is not None and np.array_equal(
                ids, np.arange(ids[0], ids[0] + len(ids))
            ):
                self._ranges.append((int(ids[0]), int(ids[0]) + len(ids)))
            else:
                self._ranges = None  # mixed/non-contiguous: global index
            all_ids.append(ids)
            all_loc.append(
                np.stack([np.full(len(ids), b, np.int64), np.arange(len(ids))], 1)
            )
        if self._ranges is not None and any(
            self._ranges[i][0] < self._ranges[i - 1][1]
            for i in range(1, len(self._ranges))
        ):
            # contiguous per block but not globally ascending (blocks
            # written out of id order): the range searchsorted would
            # mis-route — fall back to the sorted global index
            self._ranges = None
        if self._ranges is None:
            cat = np.concatenate(all_ids)
            order = np.argsort(cat, kind="stable")
            self._sorted_ids = cat[order]
            self._sorted_loc = np.concatenate(all_loc)[order]

    def _locate(self, flat_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[n] global ids -> ([n] block, [n] row); ids must exist."""
        if self._ranges is not None:
            starts = np.array([r[0] for r in self._ranges])
            stops = np.array([r[1] for r in self._ranges])
            blk = np.searchsorted(stops, flat_ids, side="right")
            if (flat_ids < starts[blk]).any():
                raise KeyError("rescore id not present in the block store")
            return blk, flat_ids - starts[blk]
        pos = np.searchsorted(self._sorted_ids, flat_ids)
        if (pos >= len(self._sorted_ids)) .any() or (
            self._sorted_ids[np.minimum(pos, len(self._sorted_ids) - 1)]
            != flat_ids
        ).any():
            raise KeyError("rescore id not present in the block store")
        loc = self._sorted_loc[pos]
        return loc[:, 0], loc[:, 1]

    def gather(self, flat_ids: np.ndarray) -> np.ndarray:
        """[n] global ids -> [n, D] float32 exact rows."""
        blk, row = self._locate(np.asarray(flat_ids, np.int64))
        out = np.empty((len(blk), self._blocks[0].shape[1]), np.float32)
        for b in np.unique(blk):
            sel = blk == b
            out[sel] = np.asarray(self._blocks[b][row[sel]], np.float32)
        return out

    def rescore(
        self,
        queries: np.ndarray,  # [Q, D] float
        ids: np.ndarray,  # [Q, m] first-stage candidates (-1 = pad)
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scores for the candidate rows, reranked to top-k.
        Returns ([Q, k] scores, [Q, k] ids); rows short of k pad with
        id -1 / score -inf (same contract as the first stage)."""
        queries = np.asarray(queries, np.float32)
        Q, m = ids.shape
        valid = ids >= 0
        flat = ids[valid].ravel()
        rows = self.gather(flat)
        scores = np.full((Q, m), -np.inf, np.float32)
        scores[valid] = np.einsum(
            "nd,nd->n", rows, np.repeat(queries, valid.sum(1), axis=0)
        )
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        out_s = np.take_along_axis(scores, order, axis=1)
        out_i = np.take_along_axis(ids, order, axis=1)
        out_i = np.where(np.isfinite(out_s), out_i, -1)
        return out_s, out_i
