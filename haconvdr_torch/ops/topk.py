"""Exact inner-product top-k search over passage blocks (counterpart of
haconvdr_tpu/ops/topk.py).

``BlockSearcher`` streams passage blocks through the v4 search
(ops/topk_v4.py) and the fused v3 kernel (ops/fused_topk.py), seeding each
later block with the running best, and merges per-block results on the
device.  Every selection here orders
entries by an explicit integer key, never by how ``torch.topk`` or
``torch.sort`` happen to break ties, which CUDA does not promise.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from haconvdr_torch.device import DeviceLike, resolve_device, to_numpy, to_torch, torch_dtype
from haconvdr_torch.index.quantize import encode_int8_torch
from haconvdr_torch.ops.fused_topk import (
    MAX_K,
    _finish,
    fused_topk_block,
    order_keys,
    scan_topk_keys,
)
from haconvdr_torch.ops.topk_v4 import topk_block_v4, topk_block_v4_finish, topk_block_v4_launch

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


def merge_lists(
    parts: Iterable[Tuple[torch.Tensor, torch.Tensor]], k: int, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard lists ([Q, k_s] scores, [Q, k_s] ids) into one top-k
    on ``device`` (the first list's by default), ordered (score desc,
    position asc) over their concatenation in the given order, as JAX's
    all-gather + ``lax.top_k`` merges its shards
    (haconvdr_tpu/parallel/sharded_search.py:80-88).  Lists ordered (score
    desc, id asc) over ascending id ranges merge into that order again."""
    parts = list(parts)
    dev = parts[0][0].device if device is None else device
    s = torch.cat([p[0].to(dev, torch.float32) for p in parts], dim=1)
    i = torch.cat([p[1].to(dev) for p in parts], dim=1)
    keys = order_keys(s, torch.arange(s.shape[1], device=dev)[None, :])
    pos = torch.topk(keys, min(k, s.shape[1]), dim=1).indices
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
    v4: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's exact top-k, routed as the JAX package routes it (the
    one router of ShardedIndex and BlockSearcher):

    * k > 128: the plain matmul + selection path (the kernels' buffers are
      k <= 128 designs, as the TPU kernels' were); int8 passages score the
      bfloat16-rounded folded queries there;
    * unseeded with ``v4``: the v4 search (ops/topk_v4.py), int8 x int8 for
      int8 passages, with its counted v3 fallback;
    * else the fused v3 kernel, seeded by ``init_scores`` when given."""
    if k > MAX_K:
        return topk_block(queries, passages, n_valid, k, chunk)
    if v4 and init_scores is None:
        return topk_block_v4(queries, passages, n_valid, k)
    return fused_topk_block(queries, passages, n_valid, k, init_scores=init_scores)


def block_topk_launch(
    queries: torch.Tensor,
    passages: torch.Tensor,
    n_valid: int,
    k: int,
    chunk: int = 65536,
    v4: bool = False,
):
    """:func:`block_topk` (unseeded) with its device work queued: the v4
    route stops before its host sync, the others run whole.  Hand the
    result to :func:`block_topk_finish`."""
    if v4 and k <= MAX_K:
        return topk_block_v4_launch(queries, passages, n_valid, k)
    return block_topk(queries, passages, n_valid, k, chunk, v4=v4)


def block_topk_finish(state) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (scores, ids) of a :func:`block_topk_launch`."""
    return state if len(state) == 2 else topk_block_v4_finish(state)


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
    (counterpart of haconvdr_tpu/ops/topk.py:162 BlockSearcher on its
    kernel path, ``use_pallas`` with ``blocks_per_dispatch=1``).

    * The stream's first block is unseeded: from ``v4_min_rows`` rows it
      runs the v4 search (ops/topk_v4.py), below that the fused v3 kernel.
      Every later block runs the v3 kernel seeded with the running best,
      so only rows that can still enter survive its threshold; seed
      survivors come back with id -1 and are dropped at the merge, which
      re-supplies them from the running best.  k > 128 takes the plain
      path (no seeding).
    * A block may be (emb, ids, scale): int8 codes with their [D]
      dequantization scale, folded into float32 queries for that block.
    * ``superblock_rows`` > 0: blocks are copied into one device-resident
      [superblock_rows, D] accumulator, and each filled accumulator (and the
      partial last one) is searched once, unseeded.  ``superblock_dtype``
      "int8" keeps the accumulator in int8, requantizing every block to the
      corpus scale ``superblock_scale`` ([D]; EmbeddingBlockStore.
      global_scale()); otherwise int8 blocks are dequantized into the
      accumulator's compute dtype.  The TPU's 2048-row multiple does not
      apply: rows past the fill are masked by ``n_valid``.
    """

    def __init__(
        self,
        top_k: int = 100,
        passage_chunk: int = 65536,
        query_chunk: int = 1024,
        compute_dtype: str = "float32",
        device: DeviceLike = None,
        v4_min_rows: int = 1_500_000,
        superblock_rows: int = 0,
        superblock_dtype: str = "",
        superblock_scale=None,
    ):
        if superblock_dtype not in ("", "int8"):
            raise ValueError(f"superblock_dtype must be '' or 'int8', got {superblock_dtype!r}")
        if superblock_dtype == "int8" and not superblock_rows:
            raise ValueError("superblock_dtype needs superblock_rows")
        if superblock_rows < 0:
            raise ValueError(f"superblock_rows must be >= 0, got {superblock_rows}")
        self.top_k = top_k
        self.passage_chunk = passage_chunk
        self.query_chunk = query_chunk
        self.compute_dtype = torch_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.v4_min_rows = v4_min_rows
        self.superblock_rows = superblock_rows
        self.superblock_dtype = superblock_dtype
        self.superblock_scale = superblock_scale if superblock_dtype == "int8" else None
        self._init_kw = dict(
            passage_chunk=passage_chunk, query_chunk=query_chunk,
            compute_dtype=compute_dtype, device=device, v4_min_rows=v4_min_rows,
            superblock_rows=superblock_rows, superblock_dtype=superblock_dtype,
            superblock_scale=superblock_scale,
        )

    def with_top_k(self, top_k: int) -> "BlockSearcher":
        """A clone with another k (used by the two-stage rescore path to
        oversample the first stage); k > 128 takes the plain path."""
        if top_k == self.top_k:
            return self
        return BlockSearcher(top_k=top_k, **self._init_kw)

    def _one_block(self, best_s, best_ids, queries, passages, ids_t, n_valid, first):
        k = self.top_k
        v4 = passages.shape[0] >= self.v4_min_rows
        s_parts, i_parts = [], []
        for qs in range(0, queries.shape[0], self.query_chunk):
            qe = min(queries.shape[0], qs + self.query_chunk)
            init = None if first or k > MAX_K else best_s[qs:qe]
            s, i = block_topk(
                queries[qs:qe], passages, n_valid, k, self.passage_chunk, init, v4=v4
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

    def _block(self, item):
        """(passages on the device, scale tensor or None, ids) of a block."""
        emb, ids = item[0], item[1]
        scale = item[2] if len(item) > 2 else None
        if str(emb.dtype) in ("int8", "torch.int8"):  # numpy or torch codes
            if scale is None:
                # scoring raw quantized codes unscaled is silently wrong
                raise ValueError(
                    "int8 block without a dequant scale: pass (emb, ids, scale) "
                    "(store.iter_blocks(with_scales=True))"
                )
            passages = to_torch(emb, self.device)
        else:
            passages = to_torch(emb, self.device, self.compute_dtype)
        if scale is not None:
            scale = to_torch(scale, self.device, torch.float32)
        return passages.contiguous(), scale, ids

    def search(
        self,
        query_embs,  # [Q, D] numpy array or tensor
        blocks: Iterable[Tuple],  # (emb [Nb, D], ids [Nb][, scale [D]])
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
        if self.superblock_rows:
            best_s, best_ids = self._stream_superblocks(queries, blocks, best_s, best_ids)
        else:
            first = True
            for item in blocks:
                passages, scale, ids = self._block(item)
                if passages.shape[0] == 0:
                    continue
                q_eff = queries if scale is None else queries.to(torch.float32) * scale
                best_s, best_ids = self._one_block(
                    best_s, best_ids, q_eff, passages, ids_to_int32(ids, dev),
                    passages.shape[0], first,
                )
                first = False
        if return_device:
            return best_s, best_ids
        return to_numpy(best_s), to_numpy(best_ids)

    def _stream_superblocks(self, queries, blocks, best_s, best_ids):
        """Accumulate blocks into one device buffer and search each filled
        buffer once, unseeded (ops/topk.py:566-669 of the JAX package);
        exact whatever the block boundaries."""
        C = self.superblock_rows
        dev = self.device
        int8_acc = self.superblock_dtype == "int8"
        q_search = queries
        if int8_acc:
            if self.superblock_scale is None:
                raise ValueError(
                    "superblock_dtype='int8' needs superblock_scale ([D] per-dim "
                    "corpus scale: EmbeddingBlockStore.global_scale())"
                )
            tscale = to_torch(self.superblock_scale, dev, torch.float32)
            q_search = queries.to(torch.float32) * tscale  # folded once
        buf = idbuf = None
        fill = 0
        for item in blocks:
            emb, scale, ids = self._block(item)
            ids_t = ids_to_int32(ids, dev)
            if int8_acc:  # requantize to the corpus scale on insert
                factor = scale / tscale if scale is not None else 1.0 / tscale
            elif scale is not None:  # dequantize into the accumulator's dtype
                emb = emb.to(torch.float32) * scale
            if buf is None:
                buf = torch.zeros(
                    (C, emb.shape[1]), dtype=torch.int8 if int8_acc else self.compute_dtype,
                    device=dev,
                )
                idbuf = torch.full((C,), -1, dtype=torch.int32, device=dev)
            off = 0
            while off < emb.shape[0]:
                take = min(C - fill, emb.shape[0] - off)
                part = emb[off : off + take]
                buf[fill : fill + take] = (
                    encode_int8_torch(part, factor) if int8_acc else part.to(buf.dtype)
                )
                idbuf[fill : fill + take] = ids_t[off : off + take]
                fill += take
                off += take
                if fill == C:
                    best_s, best_ids = self._one_block(
                        best_s, best_ids, q_search, buf, idbuf, C, True
                    )
                    fill = 0
        if fill:
            best_s, best_ids = self._one_block(
                best_s, best_ids, q_search, buf, idbuf, fill, True
            )
        return best_s, best_ids
