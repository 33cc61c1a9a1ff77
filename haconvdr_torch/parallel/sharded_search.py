"""Device-resident flat inner-product index on one device (counterpart of
haconvdr_tpu/parallel/sharded_search.py:ShardedIndex).

The embeddings live on the device as one [N, D] float32 or bfloat16
tensor, searched many times.  Unlike the TPU version nothing is padded:
the kernel masks the ragged tail by ``n_valid`` itself.  k <= 128 runs the
fused top-k kernel; larger k (rescore-oversampled first stages) runs the
plain matmul + selection path (sharded_search.py:158-174).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from haconvdr_torch.device import DeviceLike, resolve_device, to_numpy, to_torch, torch_dtype
from haconvdr_torch.ops.topk import block_topk

_INT8_TODO = "int8 residency is not ported yet; it lands with the index/quantize.py port"


def _float_dtype(dtype: str) -> torch.dtype:
    if dtype == "int8":
        raise NotImplementedError(_INT8_TODO)
    return torch_dtype(dtype)


class ShardedIndex:
    """A device-resident flat inner-product index (one shard)."""

    def __init__(
        self,
        passages: torch.Tensor,  # [N, D] on the device
        ids: Optional[np.ndarray] = None,  # [N] global ids, else row offsets
        chunk: int = 65536,
    ):
        if passages.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"passages must be float32/bfloat16, got {passages.dtype}")
        if passages.shape[0] >= 2**31:
            raise ValueError("passage rows exceed int32 ids")
        self.passages = passages.contiguous()
        self.n_valid = passages.shape[0]
        self.ids = None if ids is None else np.asarray(ids)
        if self.ids is not None and len(self.ids) != self.n_valid:
            raise ValueError(f"{len(self.ids)} ids for {self.n_valid} rows")
        self.chunk = chunk

    @classmethod
    def from_tensor(
        cls,
        passages: torch.Tensor,
        ids: Optional[np.ndarray] = None,
        dtype: Optional[str] = None,
    ) -> "ShardedIndex":
        """Wrap embeddings already on the device (cast to ``dtype``)."""
        if dtype is not None:
            passages = passages.to(_float_dtype(dtype))
        return cls(passages, ids)

    @classmethod
    def from_store(
        cls,
        store,
        dtype: str = "float32",
        device: DeviceLike = None,
        num_blocks: int = -1,
        chunk: int = 65536,
    ) -> "ShardedIndex":
        """Load an EmbeddingBlockStore's blocks into one device tensor,
        block by block (sizes read from the headers first, so the corpus
        streams from disk once and is never assembled on the host)."""
        tdt = _float_dtype(dtype)
        dev = resolve_device(device)
        nb = store.num_blocks() if num_blocks < 0 else num_blocks
        sizes = [store.block_size(b) for b in range(nb)]
        n = int(sum(sizes))
        ids_all = np.empty((n,), np.int64)
        passages = None
        row = 0
        for b in range(nb):
            if store.block_scale(b) is not None:
                raise NotImplementedError(_INT8_TODO)
            emb, ids = store.read_block(b)
            if passages is None:
                passages = torch.empty((n, emb.shape[1]), dtype=tdt, device=dev)
            passages[row : row + emb.shape[0]] = to_torch(emb, dev, tdt)
            ids_all[row : row + emb.shape[0]] = ids
            row += emb.shape[0]
        if passages is None:
            raise ValueError("empty store: no blocks to index")
        return cls(passages, ids_all, chunk)

    def search_device(
        self, queries: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k], row offsets [Q, k]) as device tensors."""
        q = queries.to(device=self.passages.device, dtype=self.passages.dtype)
        return block_topk(q, self.passages, self.n_valid, k, self.chunk)

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns numpy (scores [Q, k], ids [Q, k]): global ids when an id
        array was given, else row offsets; -1 marks empty slots."""
        q = to_torch(queries, self.passages.device)
        s, i = self.search_device(q, k)
        s, i = to_numpy(s), to_numpy(i)
        if self.ids is not None:
            safe = np.clip(i, 0, self.n_valid - 1)
            i = np.where(i >= 0, self.ids[safe], -1)
        return s, i
