"""IVF built from an EmbeddingBlockStore, cut over a mesh of device slots,
searched and persisted as the JAX package's sharded IVF (counterpart of
haconvdr_tpu/parallel/sharded_ivf.py).

Layout (``shard_ivf``, ``build_ivf_from_store``): with ``n`` shards, shard
``s`` owns the whole clusters ``[s * nlist / n, (s + 1) * nlist / n)``
(n must divide nlist) and a slice of the spill tail; the centroids and
the int8 sidecars (scales, cluster means) are replicated on every device
of the mesh.  One shard is an ``IVFIndex``; several are a
:class:`ShardedIVFIndex`, one ``IVFIndex`` a slot holding its clusters
and tail slice.

``build_ivf_from_store`` streams the store and never holds the corpus on
the host: a strided k-means sample, a chunked assignment on the mesh's
first device (one int32 per row kept on the host), for residual int8 a
pass for the per-cluster and tail residual amax, then a scatter of each
chunk's rows (or int8 codes) into each owning shard's flat slab on its
device, split into buckets and tail.  Rows keep their rank within their
cluster in corpus order; spilled rows go round-robin to the shards' tails
(``spill_rank % n``, each tail padded to a multiple of 8), as JAX deals
them (:363-382).  With one shard the tail is every spilled row in corpus
order.

``sharded_ivf_search``: every shard takes the same global top-``nprobe``
probes, scores the probed clusters it owns (probe ids stay global for the
per-cluster scales and the residual ``q . mean``) and its tail slice, and
the shards' [Q, k] lists are merged on the first slot's device as the
flat index merges them (parallel/sharded_search.py).

``save_ivf_sharded`` writes JAX's per-shard files (``buckets_000.npy``
..., ``ivf_sharded_meta.json`` with ``n_shards``), which either package
loads; ``load_ivf_sharded`` re-splits a directory saved with any shard
count onto a mesh whose shard count divides nlist (clusters re-split; the
tail re-split on rows, padded with -1 ids, :680-795).  A mesh's shards
are its own slots.  With ``distributed=True`` (``shard_ivf``,
``build_ivf_from_store``, ``load_ivf_sharded``; ``torch.distributed``
initialized) they are global instead: rank r holds the slots of its own
mesh, the global order is the ranks' meshes in rank order, each rank
writes and reads only its own shards, and the shards' files and the meta
are fenced by barriers (:584-677).
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from haconvdr_torch.device import DeviceLike, to_numpy, to_torch
from haconvdr_torch.index.ivf import (
    DTYPE_NAMES,
    SIDECARS,
    IVFIndex,
    _capacity,
    _round8,
    assign_rows,
    cluster_sums,
    fill_slots,
    ivf_candidates,
    ivf_search,
    probe_clusters,
    spherical_kmeans,
)
from haconvdr_torch.ops.fused_topk import decode_keys
from haconvdr_torch.ops.topk import merge_lists
from haconvdr_torch.parallel.mesh import Mesh, barrier, dist_rank_world, make_mesh
from haconvdr_torch.utils.io import load_npy, open_npy, rows_to_device, save_npy

META = "ivf_sharded_meta.json"
SHARDED = ("buckets", "bucket_ids", "tail", "tail_ids")


class ShardedIVFIndex(NamedTuple):
    """An IVF index cut over a mesh: ``shards[i]`` is slot i's
    ``IVFIndex`` (global shard ``first_shard + i``) with its clusters'
    buckets [nlist / n_shards, capacity, D], their ids, its tail slice and
    its ids, and the replicated (global) centroids and sidecars on its
    device.  Across processes a rank holds only its own slots."""

    mesh: Mesh
    shards: Tuple[IVFIndex, ...]
    nprobe: int
    n_shards: int  # global shard count
    first_shard: int = 0

    @property
    def centroids(self) -> torch.Tensor:
        return self.shards[0].centroids

    @property
    def nlist(self) -> int:
        return int(self.shards[0].centroids.shape[0])


def _whole(index: ShardedIVFIndex) -> None:
    if len(index.shards) != index.n_shards:
        raise ValueError(
            f"this process holds {len(index.shards)} of {index.n_shards} shards; "
            "searching needs every shard in one process"
        )


def _global_slots(mesh: Mesh, distributed: bool) -> Tuple[int, int]:
    """(global shard count, global index of this process's first slot):
    the mesh's own slots, or with ``distributed`` the ranks' meshes (each
    of this one's size) in rank order."""
    if not distributed:
        return mesh.size, 0
    rank, world = dist_rank_world()
    return world * mesh.size, rank * mesh.size


def _replicas(mesh: Mesh, t: Optional[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """``t`` on every slot's device, one copy a device."""
    if t is None:
        return [None] * mesh.size
    copies = {dev: t.to(dev) for dev in mesh.distinct}
    return [copies[d] for d in mesh.slots]


def _assemble(mesh: Mesh, pieces, replicated: dict, nprobe: int, n_shards: int,
              first: int) -> ShardedIVFIndex:
    """A ShardedIVFIndex from each slot's (buckets, bucket_ids, tail,
    tail_ids) and the replicated arrays."""
    reps = {name: _replicas(mesh, replicated.get(name)) for name in ("centroids",) + SIDECARS}
    shards = tuple(
        IVFIndex(centroids=reps["centroids"][i], buckets=b, bucket_ids=bi, tail=t, tail_ids=ti,
                 nprobe=int(nprobe), **{n: reps[n][i] for n in SIDECARS})
        for i, (b, bi, t, ti) in enumerate(pieces)
    )
    return ShardedIVFIndex(mesh, shards, int(nprobe), n_shards, first)


def shard_ivf(mesh: Mesh, index: IVFIndex, distributed: bool = False):
    """Place a whole ``IVFIndex`` across the mesh in the JAX layout
    (haconvdr_tpu/parallel/sharded_ivf.py:42-83): buckets cut on the
    cluster axis (the shard count must divide nlist), the tail padded with
    -1-id zero rows to a multiple of it and cut on rows, the centroids and
    sidecars replicated.  One shard: the index on the slot's device.
    ``distributed``: this rank's slots of the ranks' global shards."""
    n, first = _global_slots(mesh, distributed)
    nlist = index.buckets.shape[0]
    if nlist % n:
        raise ValueError(f"the shard count ({n}) must divide nlist ({nlist}); build with "
                         "a matching nlist")
    if n == 1:
        dev = mesh.first
        return IVFIndex(nprobe=index.nprobe, **{
            name: None if getattr(index, name) is None else getattr(index, name).to(dev)
            for name in ("centroids",) + SHARDED + SIDECARS})
    tail, tail_ids = index.tail, index.tail_ids
    pad = -tail.shape[0] % n
    if pad:
        tail = torch.cat([tail, torch.zeros((pad, tail.shape[1]), dtype=tail.dtype,
                                            device=tail.device)])
        tail_ids = torch.cat([tail_ids, torch.full((pad,), -1, dtype=tail_ids.dtype,
                                                   device=tail_ids.device)])
    per, tr = nlist // n, tail.shape[0] // n
    pieces = []
    for i, dev in enumerate(mesh.slots):
        g = first + i
        pieces.append((index.buckets[g * per : (g + 1) * per].to(dev),
                       index.bucket_ids[g * per : (g + 1) * per].to(dev),
                       tail[g * tr : (g + 1) * tr].to(dev), tail_ids[g * tr : (g + 1) * tr].to(dev)))
    rep = {name: getattr(index, name) for name in ("centroids",) + SIDECARS}
    return _assemble(mesh, pieces, rep, index.nprobe, n, first)


def _scale_from_amax(amax: np.ndarray) -> np.ndarray:
    """``amax / 127`` (1 where amax is 0) with a host division, as JAX's
    store build makes its scales outside a jit."""
    return np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)


def build_ivf_from_store(
    mesh: Mesh,
    store,  # EmbeddingBlockStore
    nlist: int = 4096,
    nprobe: int = 64,
    slack: float = 1.3,
    train_rows: int = 262_144,
    kmeans_iters: int = 10,
    dtype: str = "bfloat16",
    seed: int = 0,
    num_blocks: int = -1,
    chunk_rows: int = 65_536,
    by_residual: bool = True,
    distributed: bool = False,
):
    """IVF straight from an EmbeddingBlockStore (haconvdr_tpu/parallel/
    sharded_ivf.py:237-532), in the JAX package's argument order; a caller
    with no mesh passes ``make_mesh(devices=[device])``.  Returns an
    ``IVFIndex`` for one shard, else a :class:`ShardedIVFIndex`.  The host
    holds one chunk of rows at a time and an int32 per row.

    Passes over the store, as JAX's: (0) the strided k-means sample; (1)
    the chunked assignment on the mesh's first device, and for int8 the
    residual build's per-cluster sums (float32 within a chunk, float64
    across) or the global build's amax; (1.5, residual int8) the
    per-cluster and tail residual amax; (2) each chunk's rows, or their
    int8 codes ``clip(rint(rows / scale))``, scattered into each owning
    shard's flat slab on its device.  JAX makes the sums and the codes on
    the host in numpy; here they are made on the device with the same
    IEEE operations, but a chunk's float32 sums add in another order, so
    the means agree within float32 rounding and a residual code may differ
    from JAX's by one at a .5 boundary.  ``dtype`` "int8" is residual
    quantization unless ``by_residual=False`` (one global [D] scale).
    With ``distributed`` (across processes) every rank runs passes 0-1.5
    and fills only its own shards."""
    dev = mesh.first
    n_shards, first = _global_slots(mesh, distributed)
    if nlist % n_shards:
        raise ValueError(f"the shard count ({n_shards}) must divide nlist ({nlist})")
    if dtype not in DTYPE_NAMES.values():
        raise ValueError("IVF bucket dtype must be float32/bfloat16/int8")
    is_int8 = dtype == "int8"
    nb = store.num_blocks() if num_blocks < 0 else num_blocks
    N = int(sum(store.block_size(b) for b in range(nb)))
    if N < nlist:
        raise ValueError(f"corpus has {N} rows < nlist={nlist}")
    nprobe = min(nprobe, nlist)
    residual = is_int8 and by_residual

    def chunks():
        """(first global row, [rows, D] float32 on the device, [rows] ids)
        of each chunk of each block."""
        row = 0
        for emb, ids in store.iter_blocks(nb):
            for s in range(0, emb.shape[0], chunk_rows):
                x = torch.from_numpy(np.array(emb[s : s + chunk_rows], np.float32)).to(dev)
                yield row + s, x, ids[s : s + chunk_rows]
            row += emb.shape[0]

    # pass 0: strided sample
    stride = max(1, N // train_rows)
    sample = np.concatenate(
        [np.asarray(emb[::stride], np.float32) for emb, _ in store.iter_blocks(nb)]
    )[: max(train_rows, nlist)]
    D = sample.shape[1]
    cent = spherical_kmeans(torch.from_numpy(sample).to(dev), nlist, kmeans_iters, seed)
    del sample

    # pass 1: assignment (+ the residual sums, or the global amax)
    assign = np.empty((N,), np.int32)
    ids_all = np.empty((N,), np.int64)
    msum = torch.zeros(nlist, D, dtype=torch.float64, device=dev)
    mcnt = torch.zeros(nlist, dtype=torch.int64, device=dev)
    amax = torch.zeros(D, device=dev)
    for g0, xc, ids in chunks():
        a = assign_rows(xc, cent)
        assign[g0 : g0 + len(a)] = a.cpu().numpy()
        ids_all[g0 : g0 + len(a)] = ids
        if residual:
            msum += cluster_sums(xc, a, nlist)  # float32 sums of a chunk, float64 across
            mcnt += torch.bincount(a, minlength=nlist)
        elif is_int8:
            amax = torch.maximum(amax, xc.abs().amax(dim=0))
    if N and ids_all.max() >= 2**31:
        raise ValueError("ids exceed int32 (IVF ids are int32)")
    capacity = _capacity(N, nlist, slack)
    in_bucket, slot = fill_slots(assign, nlist, capacity)
    per = nlist // n_shards
    n_spill = int((~in_bucket).sum())
    if n_shards == 1:
        dest_shard, dest_slot = None, slot
        tail_rows = _round8(n_spill)
    else:  # JAX's layout: whole clusters a shard, the spill dealt round-robin
        rank = slot - assign.astype(np.int64) * capacity
        spill_rank = slot - nlist * capacity
        dest_shard = np.where(in_bucket, assign // per, spill_rank % n_shards)
        dest_slot = np.where(in_bucket, (assign % per).astype(np.int64) * capacity + rank,
                             per * capacity + spill_rank // n_shards)
        tail_rows = max(8, -(-(-(-n_spill // n_shards)) // 8) * 8)
    split = per * capacity
    assign_t = torch.from_numpy(assign.astype(np.int64)).to(dev)
    in_bucket_t = torch.from_numpy(in_bucket).to(dev)
    means = mu = scale = tail_scale = None
    if is_int8 and not residual:
        scale = torch.from_numpy(_scale_from_amax(amax.cpu().numpy())).to(dev)
    if residual:
        means = torch.where(mcnt[:, None] > 0, msum / torch.clamp_min(mcnt, 1)[:, None], 0.0)
        means = means.to(torch.float32)
        mu = (msum.sum(dim=0) / max(N, 1)).to(torch.float32)
        # pass 1.5: residual amax, per cluster for bucket rows (against the
        # cluster mean) and apart for spill rows (against the corpus mean);
        # a max is exact in any order
        amax_b = torch.zeros(nlist, D, device=dev)
        amax_t = torch.zeros(D, device=dev)
        for g0, xc, _ in chunks():
            a = assign_t[g0 : g0 + len(xc)]
            ib = in_bucket_t[g0 : g0 + len(xc)][:, None]
            res = torch.where(ib, (xc - means[a]).abs(), 0.0)
            amax_b.scatter_reduce_(0, a[:, None].expand(-1, D), res, "amax")
            amax_t = torch.maximum(amax_t, torch.where(ib, 0.0, (xc - mu).abs()).amax(dim=0))
        scale = torch.from_numpy(_scale_from_amax(amax_b.cpu().numpy())).to(dev)
        tail_scale = torch.from_numpy(_scale_from_amax(amax_t.cpu().numpy())).to(dev)

    # pass 2: rows (or codes) into each owned shard's flat slab on its device
    tdt = getattr(torch, dtype)
    slots = mesh.slots
    flats = [torch.zeros(split + tail_rows, D, dtype=tdt, device=d) for d in slots]
    flat_ids = [torch.full((split + tail_rows,), -1, dtype=torch.int32, device=d) for d in slots]
    for g0, xc, _ in chunks():
        g = slice(g0, g0 + len(xc))
        if residual:
            a, ib = assign_t[g], in_bucket_t[g][:, None]
            xc = (xc - torch.where(ib, means[a], mu)) / torch.where(ib, scale[a], tail_scale)
        elif is_int8:
            xc = xc / scale
        if is_int8:
            xc = torch.clamp(torch.round(xc), -127, 127)
        rows, rids = xc.to(tdt), torch.from_numpy(ids_all[g].astype(np.int32))
        for i, d in enumerate(slots):
            if dest_shard is None:
                sel = None
            else:
                sel = np.flatnonzero(dest_shard[g] == first + i)
                if not len(sel):
                    continue
            sl = torch.from_numpy(dest_slot[g] if sel is None else dest_slot[g][sel]).to(d)
            part = rows if sel is None else rows[torch.from_numpy(sel).to(rows.device)]
            flats[i][sl] = part.to(d)
            flat_ids[i][sl] = (rids if sel is None else rids[torch.from_numpy(sel)]).to(d)

    if n_shards == 1:
        flat, fids = flats[0], flat_ids[0]
        return IVFIndex(
            centroids=cent,
            buckets=flat[:split].view(nlist, capacity, D),
            bucket_ids=fids[:split].view(nlist, capacity),
            tail=flat[split:],
            tail_ids=fids[split:],
            nprobe=int(nprobe),
            scale=scale,
            means=means,
            mu=mu,
            tail_scale=tail_scale,
        )
    pieces = [(f[:split].view(per, capacity, D), fi[:split].view(per, capacity), f[split:],
               fi[split:]) for f, fi in zip(flats, flat_ids)]
    rep = {"centroids": cent, "scale": scale, "means": means, "mu": mu,
           "tail_scale": tail_scale}
    return _assemble(mesh, pieces, rep, nprobe, n_shards, first)


def sharded_ivf_search(mesh: Mesh, index, queries, k: int = 100,
                       nprobe: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """numpy (scores [Q, k], ids [Q, k]) in the JAX package's argument
    order; ``mesh`` is the one the index lives on.  ``nprobe`` 0 is the
    index's own.  One shard: ``ivf_search``'s answers
    (haconvdr_tpu/parallel/sharded_ivf.py:535-553); several: each shard's
    candidates merged, the answers of the one-device search of the same
    index but where two candidates tie exactly."""
    if isinstance(index, IVFIndex):
        return ivf_search(index, queries, k=k, nprobe=nprobe or index.nprobe)
    if mesh.slots != index.mesh.slots:
        raise ValueError(f"the index lives on {index.mesh}, not on {mesh}")
    s, i = sharded_ivf_search_device(index, to_torch(queries, mesh.first, "float32"), k, nprobe)
    return to_numpy(s), to_numpy(i)


def sharded_ivf_search_device(
    index: ShardedIVFIndex, queries: torch.Tensor, k: int, nprobe: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] float32, ids [Q, k] int32) on the first slot's device:
    the probes once from the replicated centroids, then each shard's
    ``ivf_candidates`` on its device, merged in shard order."""
    _whole(index)
    nlist = index.nlist
    nprobe = min(nprobe or index.nprobe, nlist)
    cap = index.shards[0].buckets.shape[1]
    n_tail = sum(sh.tail.shape[0] for sh in index.shards)
    if k > nprobe * cap + n_tail:
        raise ValueError(
            f"k={k} exceeds the {nprobe * cap + n_tail} candidates of {nprobe} probed "
            f"buckets of {cap} rows and the {n_tail}-row tail"
        )
    first = index.mesh.first
    qf = queries.to(device=first, dtype=torch.float32)
    probe = probe_clusters(index.centroids, qf, nprobe)
    per = nlist // index.n_shards
    parts = []
    for g, sh in enumerate(index.shards):
        d = sh.buckets.device
        keys, ids = ivf_candidates(sh, qf.to(d), probe.to(d), k, lo=g * per)
        parts.append((decode_keys(keys)[0], ids.to(torch.int32)))
    return merge_lists(parts, k, first)


def _meta(nprobe, nlist, capacity, dim, tail_rows, dtype, corpus_rows, n_shards) -> dict:
    return {
        "version": 1,
        "n_shards": n_shards,
        "nprobe": int(nprobe),
        "nlist": int(nlist),
        "capacity": int(capacity),
        "dim": int(dim),
        "tail_rows": int(tail_rows),
        "bucket_dtype": DTYPE_NAMES[dtype],
        "corpus_rows": corpus_rows,
    }


def _write_sidecars(index, dir_path: str) -> None:
    save_npy(os.path.join(dir_path, "centroids.npy"), index.centroids)
    for name in SIDECARS:
        val = getattr(index, name)
        path = os.path.join(dir_path, name + ".npy")
        if val is not None:
            save_npy(path, val)
        elif os.path.exists(path):
            os.remove(path)  # never leave stale quantization sidecars


def save_ivf_sharded(index, dir_path: str) -> None:
    """Persist as the JAX package's sharded layout
    (haconvdr_tpu/parallel/sharded_ivf.py:584-677): ``buckets_NNN.npy``,
    ``bucket_ids_NNN.npy``, ``tail_NNN.npy``, ``tail_ids_NNN.npy`` a
    shard, the centroids and int8 sidecars (stale ones removed), and
    ``ivf_sharded_meta.json`` with the shard count, the valid-row count
    (from the saved id files) and the bucket dtype's name for the reload
    guards.  An ``IVFIndex`` is one shard.  The shards this process holds
    are written one at a time; an index spread across processes (each
    rank holding its own shards) writes them on every rank, all barrier,
    rank 0 writes the sidecars and the meta, and all barrier again."""
    os.makedirs(dir_path, exist_ok=True)
    if isinstance(index, IVFIndex):
        shards, n_shards, first = (index,), 1, 0
    else:
        shards, n_shards, first = index.shards, index.n_shards, index.first_shard
    spread = len(shards) < n_shards
    for i, sh in enumerate(shards):
        for name in SHARDED:
            save_npy(os.path.join(dir_path, f"{name}_{first + i:03d}.npy"), getattr(sh, name))
    if spread:
        barrier()
    if not spread or dist_rank_world()[0] == 0:
        sh = shards[0]
        _write_sidecars(sh, dir_path)
        corpus_rows = tail_rows = 0
        for s in range(n_shards):
            for name in ("bucket_ids", "tail_ids"):
                ids, _ = open_npy(os.path.join(dir_path, f"{name}_{s:03d}.npy"))
                corpus_rows += int((np.asarray(ids) >= 0).sum())
                if name == "tail_ids":
                    tail_rows += ids.shape[0]
        _, cap, dim = sh.buckets.shape
        meta = _meta(index.nprobe, sh.centroids.shape[0], cap, dim, tail_rows, sh.buckets.dtype,
                     corpus_rows, n_shards)
        with open(os.path.join(dir_path, META), "w") as f:
            json.dump(meta, f)
    if spread:
        barrier()  # every rank returns once the directory is complete


def load_ivf_sharded(dir_path: str, with_meta: bool = False, device: DeviceLike = None,
                     mesh: Optional[Mesh] = None, distributed: bool = False):
    """Inverse of ``save_ivf_sharded`` of either package, from any saved
    shard count (haconvdr_tpu/parallel/sharded_ivf.py:680-795), onto
    ``mesh`` (default: one slot on ``device``) of n shards (n must divide
    nlist; with ``distributed``, the ranks' global shards, each rank
    reading only its own): shard g takes the clusters ``[g * nlist / n,
    (g + 1) * nlist / n)`` and rows ``[g * R', (g + 1) * R')`` of the
    saved tails (R' = ceil(R / n), the last padded with -1-id zero rows).
    One shard is an ``IVFIndex``, several a ``ShardedIVFIndex``.  The host
    holds one slice of one file at a time.  ``with_meta=True`` returns
    ``(index, meta)`` for staleness checks."""
    if mesh is None:
        mesh = make_mesh(devices=[device])  # raises without the card before any read
    dev = mesh.first
    n_new, first = _global_slots(mesh, distributed)
    with open(os.path.join(dir_path, META)) as f:
        meta = json.load(f)
    n_saved = meta["n_shards"]
    nlist = meta["nlist"]
    if nlist % n_new:
        raise ValueError(f"the target shard count ({n_new}) must divide the saved nlist "
                         f"({nlist}); use a device count that divides {nlist}")
    opened = {}

    def saved(name, s):
        """(memory map, dtype) of saved shard ``s`` of ``name``, opened on
        first use: a rank opens only the files its shards take rows from
        (and every tail_ids header, for the tail's size)."""
        if (name, s) not in opened:
            opened[name, s] = open_npy(os.path.join(dir_path, f"{name}_{s:03d}.npy"))
        return opened[name, s]

    per_saved, per_new = nlist // n_saved, nlist // n_new
    t_sizes = [saved("tail_ids", s)[0].shape[0] for s in range(n_saved)]
    t_starts = np.concatenate([[0], np.cumsum(t_sizes)])
    R = int(t_starts[-1])
    Rp = -(-R // n_new)

    def piece(name, lo, hi, starts, d, pad_rows=0):
        """Global rows [lo, hi) of the saved slices of ``name`` on ``d``,
        then ``pad_rows`` pad rows (zeros, or -1 ids)."""
        f0 = min(int(np.searchsorted(starts, lo, side="right")) - 1, n_saved - 1)
        arr0, dtype = saved(name, f0)
        out = torch.empty((hi - lo + pad_rows,) + arr0.shape[1:], dtype=dtype, device=d)
        row = lo
        while row < hi:
            f = int(np.searchsorted(starts, row, side="right")) - 1
            arr = saved(name, f)[0]
            take = min(hi, starts[f] + arr.shape[0]) - row
            rows_to_device(arr[row - starts[f] : row - starts[f] + take], dtype, d, out, row - lo)
            row += take
        if pad_rows:
            out[hi - lo :] = -1 if name == "tail_ids" else 0
        return out

    c_starts = np.arange(n_saved + 1) * per_saved
    pieces = []
    for i, d in enumerate(mesh.slots):
        g = first + i
        a, b = min(g * Rp, R), min((g + 1) * Rp, R)
        pieces.append((
            piece("buckets", g * per_new, (g + 1) * per_new, c_starts, d),
            piece("bucket_ids", g * per_new, (g + 1) * per_new, c_starts, d),
            piece("tail", a, b, t_starts, d, Rp - (b - a)),
            piece("tail_ids", a, b, t_starts, d, Rp - (b - a)),
        ))

    def opt(name):
        path = os.path.join(dir_path, name + ".npy")
        return load_npy(path, dev) if os.path.exists(path) else None

    rep = {name: opt(name) for name in ("centroids",) + SIDECARS}
    if n_new == 1:
        index = IVFIndex(nprobe=int(meta["nprobe"]), **rep, **dict(zip(SHARDED, pieces[0])))
    else:
        index = _assemble(mesh, pieces, rep, int(meta["nprobe"]), n_new, first)
    return (index, meta) if with_meta else index
