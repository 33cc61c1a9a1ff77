"""Exact inner-product top-k search over passage blocks (counterpart of
haconvdr_tpu/ops/topk.py).

``BlockSearcher`` streams passage blocks through the fused top-k kernel
(ops/fused_topk.py), seeding each later block with the running best, and
merges per-block results on the device.  Every selection here orders
entries by an explicit integer key, never by how ``torch.topk`` or
``torch.sort`` happen to break ties, which CUDA does not promise.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from haconvdr_torch.device import DeviceLike, resolve_device, to_numpy, to_torch, torch_dtype
from haconvdr_torch.ops.fused_topk import (
    MAX_K,
    _finish,
    fused_topk_block,
    order_keys,
    scan_topk_keys,
)

NEG_INF = float("-inf")


def exact_topk_oracle(
    queries: torch.Tensor, passages: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full [Q, N] float32 score matrix + top-k, ties to the lower index.
    Test-only."""
    s = queries.to(torch.float32) @ passages.to(torch.float32).T
    keys = order_keys(s, torch.arange(s.shape[1], device=s.device)[None, :])
    pos = torch.topk(keys, k, dim=1).indices
    return torch.gather(s, 1, pos), pos.to(torch.int32)


def merge_topk(
    scores_a: torch.Tensor,
    idx_a: torch.Tensor,
    scores_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-query lists into one top-k ordered (score desc,
    position asc) over the concatenation [A | B]: A, the running state,
    wins ties, as in the reference's 2-pointer merge and JAX's stable
    ``lax.top_k`` (haconvdr_tpu/ops/topk.py:44-59)."""
    s = torch.cat([scores_a, scores_b], dim=1).to(torch.float32)
    i = torch.cat([idx_a, idx_b], dim=1)
    keys = order_keys(s, torch.arange(s.shape[1], device=s.device)[None, :])
    pos = torch.topk(keys, k, dim=1).indices
    return torch.gather(s, 1, pos), torch.gather(i, 1, pos)


def topk_block(
    queries: torch.Tensor,  # [Q, D]
    passages: torch.Tensor,  # [N, D]
    n_valid: int,
    k: int,
    chunk: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain chunked path: [Q, chunk] score tiles, an exact top-k per tile
    and a running merge (ties to the lower row).  The reference's own
    non-kernel path, taken for k > 128 (haconvdr_tpu/ops/topk.py:406-418)."""
    return _finish(scan_topk_keys(queries, passages, n_valid, k, chunk))


def block_topk(
    queries: torch.Tensor,
    passages: torch.Tensor,
    n_valid: int,
    k: int,
    chunk: int = 65536,
    init_scores: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's exact top-k: the fused kernel for k <= 128, the plain
    matmul + selection path above that (the kernel's buffers are k <= 128
    designs, as the TPU kernel's were)."""
    if k <= MAX_K:
        return fused_topk_block(queries, passages, n_valid, k, init_scores=init_scores)
    return topk_block(queries, passages, n_valid, k, chunk)


def ids_to_int32(ids, device: torch.device) -> torch.Tensor:
    """Block id array -> int32 tensor.  Host arrays are bound-checked
    (ids >= 2**31 would wrap into the -1 sentinel); device tensors must
    already be int32."""
    if isinstance(ids, torch.Tensor):
        if ids.dtype != torch.int32:
            raise ValueError(
                f"device-resident block ids must be int32 (got {ids.dtype}); "
                "cast on the host, where the 2**31 bound is checked"
            )
        return ids.to(device)
    ids = np.asarray(ids)
    if ids.size and int(ids.max()) >= 2**31:
        raise ValueError("ids exceed int32")
    return torch.from_numpy(ids.astype(np.int32)).to(device)


class BlockSearcher:
    """Searches a stream of passage-embedding blocks, merging on the device
    (counterpart of haconvdr_tpu/ops/topk.py:162 BlockSearcher with
    ``use_pallas`` and ``blocks_per_dispatch=1``).

    Each block runs the fused top-k (ops/fused_topk.py); every block after
    the first is seeded with the running best, so only rows that can still
    enter survive the kernel's threshold.  Seed survivors come back with id
    -1 and are dropped at the merge, which re-supplies them from the
    running best.
    """

    def __init__(
        self,
        top_k: int = 100,
        passage_chunk: int = 65536,
        query_chunk: int = 1024,
        compute_dtype: str = "float32",
        device: DeviceLike = None,
        superblock_rows: int = 0,
        superblock_dtype: str = "",
    ):
        if superblock_rows or superblock_dtype:
            raise NotImplementedError(
                "superblock accumulation (superblock_rows / superblock_dtype) "
                "is not ported yet; it lands with the v4 search kernels"
            )
        self.top_k = top_k
        self.passage_chunk = passage_chunk
        self.query_chunk = query_chunk
        self.compute_dtype = torch_dtype(compute_dtype)
        self.device = resolve_device(device)
        self._init_kw = dict(
            passage_chunk=passage_chunk, query_chunk=query_chunk,
            compute_dtype=compute_dtype, device=device,
        )

    def with_top_k(self, top_k: int) -> "BlockSearcher":
        """A clone with another k (used by the two-stage rescore path to
        oversample the first stage); k > 128 takes the plain path."""
        if top_k == self.top_k:
            return self
        return BlockSearcher(top_k=top_k, **self._init_kw)

    def _one_block(self, best_s, best_ids, queries, passages, ids_t, n_valid, first):
        k = self.top_k
        s_parts, i_parts = [], []
        for qs in range(0, queries.shape[0], self.query_chunk):
            qe = min(queries.shape[0], qs + self.query_chunk)
            init = None if first or k > MAX_K else best_s[qs:qe]
            s, i = block_topk(
                queries[qs:qe], passages, n_valid, k, self.passage_chunk, init
            )
            s_parts.append(s)
            i_parts.append(i)
        block_s = torch.cat(s_parts)
        block_i = torch.cat(i_parts).to(torch.int64)
        hit = block_i >= 0
        block_ids = torch.where(
            hit, ids_t[block_i.clamp(0, max(n_valid - 1, 0))], -1
        )
        block_s = torch.where(hit, block_s, NEG_INF)
        return merge_topk(best_s, best_ids, block_s, block_ids.to(torch.int32), k)

    def search(
        self,
        query_embs,  # [Q, D] numpy array or tensor
        blocks: Iterable[Tuple],  # (emb [Nb, D], ids [Nb][, scale])
        return_device: bool = False,
    ):
        """Returns (scores [Q, k], passage ids [Q, k]) over all blocks; ids
        are mapped through each block's id array."""
        k = self.top_k
        dev = self.device
        queries = to_torch(query_embs, dev, self.compute_dtype)
        Q = queries.shape[0]
        best_s = torch.full((Q, k), NEG_INF, device=dev)
        best_ids = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
        first = True
        for item in blocks:
            emb, ids = item[0], item[1]
            scale = item[2] if len(item) > 2 else None
            if scale is not None or str(emb.dtype) in ("int8", "torch.int8"):
                raise NotImplementedError(
                    "int8 index blocks are not ported yet; they land with "
                    "the index/quantize.py port"
                )
            passages = to_torch(emb, dev, self.compute_dtype).contiguous()
            if passages.shape[0] == 0:
                continue
            ids_t = ids_to_int32(ids, dev)
            best_s, best_ids = self._one_block(
                best_s, best_ids, queries, passages, ids_t, passages.shape[0], first
            )
            first = False
        if return_device:
            return best_s, best_ids
        return to_numpy(best_s), to_numpy(best_ids)
