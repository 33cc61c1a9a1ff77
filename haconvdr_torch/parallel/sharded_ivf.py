"""IVF built from an EmbeddingBlockStore, searched and persisted as the
JAX package's sharded IVF, with one shard on one device (counterpart of
haconvdr_tpu/parallel/sharded_ivf.py).

``build_ivf_from_store`` streams the store and never holds the corpus on
the host: a strided k-means sample, a chunked assignment on the device
(one int32 per row kept on the host), for residual int8 a pass for the
per-cluster and tail residual amax, then a scatter of each chunk's rows
(or int8 codes) into one flat slab on the device, split into buckets and
tail.  With one
shard the tail is every spilled row in corpus order, padded to 8.

``save_ivf_sharded`` writes JAX's per-shard files with one shard
(``buckets_000.npy`` ..., ``ivf_sharded_meta.json``), which the JAX
package loads onto any mesh whose size divides nlist;
``load_ivf_sharded`` loads a directory saved with any shard count onto
the one device: clusters concatenated in shard order, the shards' tail
slices (with their -1 pads) concatenated likewise.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from haconvdr_torch.device import DeviceLike, resolve_device
from haconvdr_torch.index.ivf import (
    DTYPE_NAMES,
    SIDECARS,
    IVFIndex,
    _capacity,
    _round8,
    assign_rows,
    cluster_sums,
    fill_slots,
    ivf_search,
    spherical_kmeans,
)
from haconvdr_torch.utils.io import load_npy, open_npy, rows_to_device, save_npy

META = "ivf_sharded_meta.json"


def _scale_from_amax(amax: np.ndarray) -> np.ndarray:
    """``amax / 127`` (1 where amax is 0) with a host division, as JAX's
    store build makes its scales outside a jit."""
    return np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)


def build_ivf_from_store(
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
    device: DeviceLike = None,
) -> IVFIndex:
    """IVF straight from an EmbeddingBlockStore onto ``device``
    (haconvdr_tpu/parallel/sharded_ivf.py:237-532, one shard).  The host
    holds one chunk of rows at a time and an int32 per row.

    Passes over the store, as JAX's: (0) the strided k-means sample; (1)
    the chunked assignment on the device, and for int8 the residual
    build's per-cluster sums (float32 within a chunk, float64 across) or
    the global build's amax; (1.5, residual int8) the per-cluster and tail
    residual amax; (2) each chunk's rows, or their int8 codes
    ``clip(rint(rows / scale))``, scattered into one flat slab on the
    device.  JAX makes the sums and the codes on the host in numpy; here
    they are made on the device with the same IEEE operations, but a
    chunk's float32 sums add in another order, so the means agree within
    float32 rounding and a residual code may differ from JAX's by one at a
    .5 boundary.  ``dtype`` "int8" is residual quantization unless
    ``by_residual=False`` (one global [D] scale)."""
    dev = resolve_device(device)
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
    split = nlist * capacity
    flat_rows = split + _round8(int((~in_bucket).sum()))
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

    # pass 2: rows (or codes) into the flat slab on the device
    tdt = getattr(torch, dtype)
    flat = torch.zeros(flat_rows, D, dtype=tdt, device=dev)
    flat_ids = torch.full((flat_rows,), -1, dtype=torch.int32, device=dev)
    for g0, xc, _ in chunks():
        g = slice(g0, g0 + len(xc))
        if residual:
            a, ib = assign_t[g], in_bucket_t[g][:, None]
            xc = (xc - torch.where(ib, means[a], mu)) / torch.where(ib, scale[a], tail_scale)
        elif is_int8:
            xc = xc / scale
        if is_int8:
            xc = torch.clamp(torch.round(xc), -127, 127)
        sl = torch.from_numpy(slot[g]).to(dev)
        flat[sl] = xc.to(tdt)
        flat_ids[sl] = torch.from_numpy(ids_all[g].astype(np.int32)).to(dev)

    return IVFIndex(
        centroids=cent,
        buckets=flat[:split].view(nlist, capacity, D),
        bucket_ids=flat_ids[:split].view(nlist, capacity),
        tail=flat[split:],
        tail_ids=flat_ids[split:],
        nprobe=int(nprobe),
        scale=scale,
        means=means,
        mu=mu,
        tail_scale=tail_scale,
    )


def sharded_ivf_search(
    index: IVFIndex, queries, k: int = 100, nprobe: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [Q, k], ids [Q, k]) over the one shard: ``ivf_search``'s
    answers (haconvdr_tpu/parallel/sharded_ivf.py:535-553).  ``nprobe`` 0
    is the index's own."""
    return ivf_search(index, queries, k=k, nprobe=nprobe or index.nprobe)


def save_ivf_sharded(index: IVFIndex, dir_path: str) -> None:
    """Persist as the JAX package's sharded layout with one shard
    (haconvdr_tpu/parallel/sharded_ivf.py:584-677): ``buckets_000.npy``,
    ``bucket_ids_000.npy``, ``tail_000.npy``, ``tail_ids_000.npy``, the
    centroids and int8 sidecars (stale ones removed), and
    ``ivf_sharded_meta.json`` with the valid-row count and the bucket
    dtype's name for the reload guards."""
    os.makedirs(dir_path, exist_ok=True)
    for name in ("buckets", "bucket_ids", "tail", "tail_ids"):
        save_npy(os.path.join(dir_path, f"{name}_000.npy"), getattr(index, name))
    save_npy(os.path.join(dir_path, "centroids.npy"), index.centroids)
    for name in SIDECARS:
        val = getattr(index, name)
        path = os.path.join(dir_path, name + ".npy")
        if val is not None:
            save_npy(path, val)
        elif os.path.exists(path):
            os.remove(path)  # never leave stale quantization sidecars
    corpus_rows = int((index.bucket_ids >= 0).sum()) + int((index.tail_ids >= 0).sum())
    with open(os.path.join(dir_path, META), "w") as f:
        json.dump(
            {
                "version": 1,
                "n_shards": 1,
                "nprobe": int(index.nprobe),
                "nlist": int(index.buckets.shape[0]),
                "capacity": int(index.buckets.shape[1]),
                "dim": int(index.buckets.shape[2]),
                "tail_rows": int(index.tail.shape[0]),
                "bucket_dtype": DTYPE_NAMES[index.buckets.dtype],
                "corpus_rows": corpus_rows,
            },
            f,
        )


def load_ivf_sharded(dir_path: str, with_meta: bool = False, device: DeviceLike = None):
    """Inverse of ``save_ivf_sharded`` of either package, from any saved
    shard count, onto ``device`` (haconvdr_tpu/parallel/sharded_ivf.py:680-795
    with one target shard).  The host holds one slice of one file at a time.
    ``with_meta=True`` returns ``(index, meta)`` for staleness checks."""
    dev = resolve_device(device)
    with open(os.path.join(dir_path, META)) as f:
        meta = json.load(f)
    n_saved = meta["n_shards"]

    def concat(name):
        parts = [open_npy(os.path.join(dir_path, f"{name}_{s:03d}.npy")) for s in range(n_saved)]
        dtype = parts[0][1]
        shape = (sum(p.shape[0] for p, _ in parts),) + parts[0][0].shape[1:]
        out = torch.empty(shape, dtype=dtype, device=dev)
        row = 0
        for arr, _ in parts:
            rows_to_device(arr, dtype, dev, out, row)
            row += arr.shape[0]
        return out

    def opt(name):
        path = os.path.join(dir_path, name + ".npy")
        return load_npy(path, dev) if os.path.exists(path) else None

    index = IVFIndex(
        centroids=opt("centroids"),
        buckets=concat("buckets"),
        bucket_ids=concat("bucket_ids"),
        tail=concat("tail"),
        tail_ids=concat("tail_ids"),
        nprobe=int(meta["nprobe"]),
        **{name: opt(name) for name in SIDECARS},
    )
    return (index, meta) if with_meta else index
