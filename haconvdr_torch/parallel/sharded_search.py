"""Device-resident flat inner-product index on one device (counterpart of
haconvdr_tpu/parallel/sharded_search.py:ShardedIndex and sharded_topk).

The embeddings live on the device as one [N, D] float32, bfloat16 or int8
tensor, searched many times.  Unlike the TPU version nothing is padded:
the kernels mask the ragged tail by ``n_valid`` themselves.

* k <= 128 runs the v4 search (``kernel="v4"``, the JAX default:
  ops/topk_v4.py, with its v3 fallback) or the fused v3 kernel
  (``kernel="v3"``); larger k (rescore-oversampled first stages) runs the
  plain matmul + selection path (sharded_search.py:158-174).
* int8: per-dimension codes and one [D] scale for the whole index (one
  shard); ``search`` folds the scale into float32 queries
  (sharded_search.py:60-61,298-301).  Two scoring models follow, as in
  the JAX package: k <= 128 scores int8 x int8 (the v4 search quantizes
  the folded queries per query), k > 128 scores the bfloat16-rounded
  folded queries against the codes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from haconvdr_torch.device import DeviceLike, resolve_device, to_numpy, to_torch, torch_dtype
from haconvdr_torch.index.quantize import dequantize_int8, quantize_int8, quantize_int8_torch
from haconvdr_torch.ops.topk import block_topk

KERNELS = ("v4", "v3")


class ShardedIndex:
    """A device-resident flat inner-product index (one shard)."""

    def __init__(
        self,
        passages: torch.Tensor,  # [N, D] on the device
        ids: Optional[np.ndarray] = None,  # [N] global ids, else row offsets
        chunk: int = 65536,
        scale: Optional[torch.Tensor] = None,  # [D] float32, int8 passages only
        kernel: str = "v4",
    ):
        if passages.dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(f"passages must be float32/bfloat16/int8, got {passages.dtype}")
        if (passages.dtype == torch.int8) != (scale is not None):
            raise ValueError("int8 passages need their [D] scale, and only they take one")
        if passages.shape[0] >= 2**31:
            raise ValueError("passage rows exceed int32 ids")
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
        self.passages = passages.contiguous()
        self.scale = None if scale is None else scale.to(
            device=passages.device, dtype=torch.float32
        )
        self.n_valid = passages.shape[0]
        self.ids = None if ids is None else np.asarray(ids)
        if self.ids is not None and len(self.ids) != self.n_valid:
            raise ValueError(f"{len(self.ids)} ids for {self.n_valid} rows")
        self.chunk = chunk
        self.kernel = kernel

    @classmethod
    def from_tensor(
        cls,
        passages: torch.Tensor,
        ids: Optional[np.ndarray] = None,
        dtype: Optional[str] = None,
        kernel: str = "v4",
    ) -> "ShardedIndex":
        """Wrap embeddings already on the device (cast to ``dtype``; "int8"
        quantizes them on the device)."""
        if dtype == "int8":
            codes, scale = quantize_int8_torch(passages)
            return cls(codes, ids, scale=scale, kernel=kernel)
        if dtype is not None:
            passages = passages.to(torch_dtype(dtype))
        return cls(passages, ids, kernel=kernel)

    @classmethod
    def from_store(
        cls,
        store,
        dtype: str = "float32",
        device: DeviceLike = None,
        num_blocks: int = -1,
        chunk: int = 65536,
        kernel: str = "v4",
    ) -> "ShardedIndex":
        """Load an EmbeddingBlockStore's blocks into one device tensor.
        Float dtypes fill it block by block (sizes read from the headers
        first, so the corpus streams from disk once).  int8 quantizes the
        whole index with the shared numpy ``quantize_int8``, as the JAX
        package quantizes a shard, so it assembles the float rows on the
        host first.  int8 store blocks are dequantized as they are read
        (sharded_search.py:239-243)."""
        dev = resolve_device(device)
        is_int8 = dtype == "int8"
        tdt = None if is_int8 else torch_dtype(dtype)
        nb = store.num_blocks() if num_blocks < 0 else num_blocks
        sizes = [store.block_size(b) for b in range(nb)]
        n = int(sum(sizes))
        ids_all = np.empty((n,), np.int64)
        rows = None
        row = 0
        for b in range(nb):
            emb, ids = store.read_block(b)
            blk_scale = store.block_scale(b)
            if blk_scale is not None:
                emb = dequantize_int8(np.asarray(emb), blk_scale)
            if rows is None:
                shape = (n, emb.shape[1])
                rows = np.empty(shape, np.float32) if is_int8 else torch.empty(
                    shape, dtype=tdt, device=dev
                )
            if is_int8:
                rows[row : row + emb.shape[0]] = np.asarray(emb, np.float32)
            else:
                rows[row : row + emb.shape[0]] = to_torch(emb, dev, tdt)
            ids_all[row : row + emb.shape[0]] = ids
            row += emb.shape[0]
        if rows is None:
            raise ValueError("empty store: no blocks to index")
        if is_int8:
            codes, scale = quantize_int8(rows)
            return cls(to_torch(codes, dev), ids_all, chunk,
                       scale=to_torch(scale, dev), kernel=kernel)
        return cls(rows, ids_all, chunk, kernel=kernel)

    def search_device(
        self, queries: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k], row offsets [Q, k]) as device tensors."""
        p = self.passages
        if self.scale is not None:
            q = queries.to(device=p.device, dtype=torch.float32) * self.scale
        else:
            q = queries.to(device=p.device, dtype=p.dtype)
        return block_topk(q, p, self.n_valid, k, self.chunk, v4=self.kernel == "v4")

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
