"""Device-resident flat inner-product index, sharded over a mesh of device
slots (counterpart of haconvdr_tpu/parallel/sharded_search.py:ShardedIndex
and sharded_topk).

The passages are cut along the passage axis as the JAX package cuts them:
``shard_rows = ceil(ceil(n / n_shards) / chunk) * chunk`` rows a shard
(sharded_search.py:127-131, :211-213), so shard ``s`` owns the global
rows ``[s * shard_rows, (s + 1) * shard_rows)``.  Unlike the TPU version
nothing is padded: a shard holds only its valid rows and the kernels mask
by ``n_valid`` themselves, so a corpus under one ``chunk`` lands whole in
shard 0 and leaves the later shards empty.  An empty shard launches
nothing.

* Per shard, on its slot's device, the one router ``ops/topk.block_topk``:
  k <= 128 runs the v4 search (``kernel="v4"``, the JAX default:
  ops/topk_v4.py, with its v3 fallback) or the fused v3 kernel
  (``kernel="v3"``); larger k (rescore-oversampled first stages) runs the
  plain matmul + selection path (sharded_search.py:158-174).  Every
  shard's v4 search is launched before any shard's host sync.
* Offsets become global as ``base + local`` (-1 stays -1), and the
  shards' [Q, k] lists meet on the mesh's first device in one top-k over
  their concatenation in shard order, ordered (score desc, position asc)
  as JAX's all-gather + ``lax.top_k`` (:80-88); each list is ordered
  (score desc, id asc), so the merge keeps that order on global ids.
* int8: per-dimension codes and each shard's own [D] scale
  (``quantize_int8`` of the shard's rows; an empty shard gets the scale of
  an all-zero shard, as JAX's zero padding gives it), folded into float32
  queries per shard (:60-61, :137-146).  Two scoring models follow, as in
  the JAX package: k <= 128 scores int8 x int8 (the v4 search quantizes the
  folded queries per query), k > 128 scores the bfloat16-rounded folded
  queries against the codes.

A mesh of one slot is one shard of every row on that device: the search
is one ``block_topk`` with no merge.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from haconvdr_torch.device import to_numpy, to_torch, torch_dtype
from haconvdr_torch.index.quantize import dequantize_int8, quantize_int8, quantize_int8_torch
from haconvdr_torch.ops.topk import block_topk_finish, block_topk_launch, merge_lists
from haconvdr_torch.parallel.mesh import Mesh, make_mesh

KERNELS = ("v4", "v3")


def shard_row_count(n_valid: int, n_shards: int, chunk: int) -> int:
    """Rows a shard owns: ``ceil(n / n_shards)`` rounded up to ``chunk``,
    the JAX package's cut."""
    rows = -(-n_valid // n_shards)
    return max(chunk, -(-rows // chunk) * chunk)


def zero_shard_scale(dim: int) -> np.ndarray:
    """The [D] int8 scale ``quantize_int8`` gives a shard of zero rows."""
    return quantize_int8(np.zeros((1, dim), np.float32))[1]


class Shard(NamedTuple):
    passages: torch.Tensor  # [rows, D] the shard's valid rows, on its slot's device
    base: int  # global row of its first row
    scale: Optional[torch.Tensor] = None  # [D] float32, int8 passages only


def sharded_topk(
    mesh: Mesh,
    queries: torch.Tensor,  # [Q, D]
    shards: Sequence[torch.Tensor],  # one [rows_s, D] tensor a slot
    n_valid: int,
    k: int,
    chunk: int = 65536,
    scales: Optional[Sequence[torch.Tensor]] = None,  # one [D] a slot, int8 only
    kernel: str = "v4",
    bases: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([Q, k] scores, [Q, k] global offsets) over every shard, on the
    mesh's first device.  Shard ``s`` starts at global row ``bases[s]``
    (default ``s * shards[0].shape[0]``, JAX's equal shards) and holds
    ``clip(n_valid - base, 0, rows_s)`` valid rows."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} slots")
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if bases is None:
        bases = [s * shards[0].shape[0] for s in range(len(shards))]
    launched = []
    for s, p in enumerate(shards):
        rows = max(0, min(int(n_valid) - bases[s], p.shape[0]))
        if rows == 0:
            continue  # an empty shard launches nothing
        if scales is not None:  # fold this shard's dequant scale into the queries
            q = queries.to(device=p.device, dtype=torch.float32) * scales[s]
        else:
            q = queries.to(device=p.device, dtype=p.dtype)
        launched.append((bases[s], block_topk_launch(q, p, rows, k, chunk, v4=kernel == "v4")))
    if not launched:
        Q, dev = queries.shape[0], mesh.first
        return (torch.full((Q, k), float("-inf"), device=dev),
                torch.full((Q, k), -1, dtype=torch.int32, device=dev))
    parts = []
    for base, state in launched:
        s, i = block_topk_finish(state)
        parts.append((s, torch.where(i >= 0, i + base, -1) if base else i))
    if len(parts) == 1 and parts[0][0].device == mesh.first:
        return parts[0]
    return merge_lists(parts, k, mesh.first)


class ShardedIndex:
    """A device-resident flat inner-product index over a mesh of slots:
    ``ShardedIndex(mesh, embeddings, ids=None, chunk=65536,
    dtype="float32", kernel="v4")``, the JAX package's constructor.  Host
    rows (numpy) or a tensor are cut into the mesh's shards and cast to
    ``dtype`` ("int8" quantizes each shard with its own scale).  A caller
    with no mesh passes ``make_mesh(devices=[device])``, or wraps a tensor
    already on its device with ``from_tensor``; ``from_store`` streams an
    EmbeddingBlockStore into the shards.
    """

    def __init__(
        self,
        mesh: Mesh,
        embeddings,  # [N, D] numpy rows or a tensor
        ids: Optional[np.ndarray] = None,
        chunk: int = 65536,
        dtype: str = "float32",
        kernel: str = "v4",
    ):
        if dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"dtype must be float32/bfloat16/int8, got {dtype!r}")
        n, dim = embeddings.shape
        shard_rows = shard_row_count(n, mesh.size, chunk)
        shards = []
        for s, dev in enumerate(mesh.slots):
            base = s * shard_rows
            a, b = min(base, n), min(base + shard_rows, n)
            part = embeddings[a:b]
            if dtype != "int8":
                shards.append(Shard(to_torch(part, dev, dtype).contiguous(), base))
            elif b == a:
                codes = torch.empty((0, dim), dtype=torch.int8, device=dev)
                shards.append(Shard(codes, base, to_torch(zero_shard_scale(dim), dev)))
            elif isinstance(part, torch.Tensor):
                codes, scale = quantize_int8_torch(part.to(dev))
                shards.append(Shard(codes, base, scale))
            else:
                codes, scale = quantize_int8(part)
                shards.append(Shard(to_torch(codes, dev), base, to_torch(scale, dev)))
        self._finish_init(mesh, shards, n, ids, chunk, kernel)

    def _finish_init(self, mesh, shards: List[Shard], n_valid, ids, chunk, kernel):
        if n_valid >= 2**31:
            raise ValueError("passage rows exceed int32 ids")
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
        self.mesh = mesh
        self.shards = shards
        self.n_valid = int(n_valid)
        self.ids = None if ids is None else np.asarray(ids)
        if self.ids is not None and len(self.ids) != self.n_valid:
            raise ValueError(f"{len(self.ids)} ids for {self.n_valid} rows")
        self.chunk = chunk
        self.kernel = kernel

    # one-shard views (the form every single-device caller holds)
    @property
    def passages(self) -> torch.Tensor:
        if len(self.shards) != 1:
            raise AttributeError("a sharded index has no one passages tensor: see .shards")
        return self.shards[0].passages

    @property
    def scale(self) -> Optional[torch.Tensor]:
        if len(self.shards) != 1:
            raise AttributeError("a sharded index has a scale a shard: see .scales")
        return self.shards[0].scale

    @property
    def scales(self) -> Optional[torch.Tensor]:
        """[n_shards, D] int8 scales on the first slot's device (JAX's
        ``ShardedIndex.scales``), None for a float index."""
        if self.shards[0].scale is None:
            return None
        return torch.stack([sh.scale.to(self.mesh.first) for sh in self.shards])

    @classmethod
    def from_tensor(
        cls,
        passages: torch.Tensor,
        ids: Optional[np.ndarray] = None,
        dtype: Optional[str] = None,
        kernel: str = "v4",
        mesh: Optional[Mesh] = None,
    ) -> "ShardedIndex":
        """Wrap float embeddings already on the device, cut into the
        mesh's shards (default: one slot on their device) and cast to
        ``dtype`` (None keeps theirs; "int8" quantizes on the device)."""
        if passages.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"passages must be float32/bfloat16, got {passages.dtype}")
        if mesh is None:
            mesh = make_mesh(devices=[passages.device])
        return cls(mesh, passages, ids, dtype=dtype or str(passages.dtype).split(".")[1],
                   kernel=kernel)

    @classmethod
    def from_store(cls, mesh: Mesh, store, chunk: int = 65536, dtype: str = "float32",
                   num_blocks: int = -1, kernel: str = "v4") -> "ShardedIndex":
        """Load an EmbeddingBlockStore's blocks into the shards that own
        them, in the JAX package's argument order.

        Rows stream from disk into the shard that owns them (sizes read
        from the block headers first, so the corpus streams once) and no
        host buffer of the whole corpus is built.  Float shards fill on
        their devices; int8 fills one shard of float32 rows on the host at
        a time and quantizes it with the shared numpy ``quantize_int8`` when
        it is full, as JAX's ``place`` does (sharded_search.py:223-228).
        int8 store blocks are dequantized as they are read (:239-243)."""
        is_int8 = dtype == "int8"
        tdt = None if is_int8 else torch_dtype(dtype)
        nb = store.num_blocks() if num_blocks < 0 else num_blocks
        n = int(sum(store.block_size(b) for b in range(nb)))
        if n == 0:
            raise ValueError("empty store: no blocks to index")
        slots = mesh.slots
        shard_rows = shard_row_count(n, len(slots), chunk)
        sizes = [max(0, min(shard_rows, n - s * shard_rows)) for s in range(len(slots))]
        ids_all = np.empty((n,), np.int64)
        shards: List[Shard] = []
        buf = None  # the filling shard: a device tensor, or host float32 rows for int8

        def close(fill):
            if is_int8:
                if fill:
                    codes, scale = quantize_int8(buf)
                else:
                    codes, scale = np.zeros((0, dim), np.int8), zero_shard_scale(dim)
                dev = slots[len(shards)]
                shards.append(Shard(to_torch(codes, dev), len(shards) * shard_rows,
                                    to_torch(scale, dev)))
            else:
                shards.append(Shard(buf, len(shards) * shard_rows))

        def open_next():
            size, dev = sizes[len(shards)], slots[len(shards)]
            if is_int8:
                return np.empty((size, dim), np.float32)
            return torch.empty((size, dim), dtype=tdt, device=dev)

        fill = row = 0
        for b in range(nb):
            emb, ids = store.read_block(b)
            blk_scale = store.block_scale(b)
            if blk_scale is not None:
                emb = dequantize_int8(np.asarray(emb), blk_scale)
            if buf is None:
                dim = emb.shape[1]
                buf = open_next()
            ids_all[row : row + emb.shape[0]] = ids
            row += emb.shape[0]
            off = 0
            while off < emb.shape[0]:
                take = min(sizes[len(shards)] - fill, emb.shape[0] - off)
                part = emb[off : off + take]
                if is_int8:
                    buf[fill : fill + take] = np.asarray(part, np.float32)
                else:
                    buf[fill : fill + take] = to_torch(part, buf.device, tdt)
                fill += take
                off += take
                if fill == sizes[len(shards)]:
                    close(fill)
                    fill = 0
                    if len(shards) < len(slots):
                        buf = open_next()
        while len(shards) < len(slots):  # the shards past the corpus: empty
            close(0)
            if len(shards) < len(slots):
                buf = open_next()
        obj = cls.__new__(cls)
        obj._finish_init(mesh, shards, n, ids_all, chunk, kernel)
        return obj

    def search_device(
        self, queries: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k], global row offsets [Q, k]) as tensors on the
        mesh's first device."""
        sh = self.shards
        scales = None if sh[0].scale is None else [s.scale for s in sh]
        return sharded_topk(self.mesh, queries, [s.passages for s in sh], self.n_valid, k,
                            self.chunk, scales, self.kernel, [s.base for s in sh])

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns numpy (scores [Q, k], ids [Q, k]): global ids when an id
        array was given, else row offsets; -1 marks empty slots."""
        q = to_torch(queries, self.mesh.first)
        s, i = self.search_device(q, k)
        s, i = to_numpy(s), to_numpy(i)
        if self.ids is not None:
            safe = np.clip(i, 0, self.n_valid - 1)
            i = np.where(i >= 0, self.ids[safe], -1)
        return s, i
