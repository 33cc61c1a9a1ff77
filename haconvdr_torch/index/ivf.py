"""Cluster-pruned IVF (inverted-file) index on one device (counterpart of
haconvdr_tpu/index/ivf.py).

Spherical k-means centroids, one dense [nlist, capacity, D] bucket tensor
(every cluster padded to the same capacity, pad rows carry id -1) and an
always-scanned tail for the rows that overflow a full bucket.  A query
scores the buckets of its top ``nprobe`` centroids and the tail, exactly
in float32, and keeps the top k: IVF answers are exact over the rows it
reads, and at ``nprobe == nlist`` equal the flat exact search.

Buckets are float32, bfloat16 or int8 (``quantize_ivf``): one global [D]
scale, or residual codes of ``row - mean(cluster)`` with per-cluster
[nlist, D] scales, the cluster means added back exactly at search.

The layout, the fill rule (rank within the cluster in corpus order,
overflow to the tail in corpus order, tail padded to a multiple of 8),
the scoring model and the files ``save_ivf`` writes are the JAX
package's, so an index built by either package is searched and loaded by
the other.  Two things differ by design:

* the k-means init rows come from :func:`init_rows` (a torch generator),
  not from ``jax.random.choice``;
* the k-means update sums the rows of a cluster with a one-hot GEMM per
  chunk, not a scatter-add: atomic float adds on the card change their
  order between runs, and two builds from one seed must give the same
  centroids.

There is no kernel of its own here: the search and the build are torch
GEMMs, gathers and selections on the index's device.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from haconvdr_torch.device import DeviceLike, resolve_device, to_numpy, to_torch
from haconvdr_torch.ops.fused_topk import decode_keys, order_keys
from haconvdr_torch.utils.io import load_npy, save_npy

ASSIGN_ROWS = 65536  # rows per assignment pass (bounds the [rows, nlist] scores)
PANEL_BYTES = 1 << 31  # float32 bytes of probed bucket rows scored at once
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}
ARRAYS = ("centroids", "buckets", "bucket_ids", "tail", "tail_ids")
SIDECARS = ("scale", "means", "mu", "tail_scale")


class IVFIndex(NamedTuple):
    """Static-shape inverted file: dense buckets + always-scanned tail
    (haconvdr_tpu/index/ivf.py:80-102)."""

    centroids: torch.Tensor  # [nlist, D] float32, unit norm
    buckets: torch.Tensor  # [nlist, capacity, D] store dtype; zero-padded
    bucket_ids: torch.Tensor  # [nlist, capacity] int32 global ids; -1 pad
    tail: torch.Tensor  # [tail_rows, D] overflow rows (always scanned)
    tail_ids: torch.Tensor  # [tail_rows] int32; -1 pad
    nprobe: int
    # int8 buckets only: [D] global scale, or [nlist, D] per-cluster scales
    # of residual codes (with means [nlist, D], mu [D] and the tail's own
    # tail_scale [D]); all float32
    scale: Optional[torch.Tensor] = None
    means: Optional[torch.Tensor] = None
    mu: Optional[torch.Tensor] = None
    tail_scale: Optional[torch.Tensor] = None


def ivf_index_from_jax(index, device: DeviceLike = None) -> IVFIndex:
    """The port's IVFIndex of any object with the JAX IVFIndex's fields
    (numpy or JAX arrays), on ``device``."""
    dev = resolve_device(device)
    fields = {
        name: None if getattr(index, name) is None
        else to_torch(np.asarray(getattr(index, name)), dev)
        for name in ARRAYS + SIDECARS
    }
    return IVFIndex(nprobe=int(index.nprobe), **fields)


# ---------------------------------------------------------------------------
# k-means and assignment
# ---------------------------------------------------------------------------

def init_rows(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` distinct row indices of ``range(n)`` drawn from ``seed``: the
    k-means init rows, and ``build_ivf_device``'s training sample."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=g)[:k].numpy()


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-6)


def assign_rows(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """[N] int64 nearest centroid (cosine) of each row of ``x``, in
    ``ASSIGN_ROWS`` chunks on ``cent``'s device; ties to the lower cluster."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=cent.device)
    for r0 in range(0, x.shape[0], ASSIGN_ROWS):
        xc = _unit(x[r0 : r0 + ASSIGN_ROWS].to(cent.device, torch.float32))
        out[r0 : r0 + ASSIGN_ROWS] = torch.argmax(xc @ cent.T, dim=1)
    return out


def cluster_sums(x: torch.Tensor, a: torch.Tensor, nlist: int) -> torch.Tensor:
    """[nlist, D] sums of the rows of ``x`` by cluster ``a``, as a one-hot
    GEMM in ``x``'s dtype: deterministic on the card, where a scatter-add
    of floats is atomic and changes its order between runs."""
    onehot = torch.zeros(x.shape[0], nlist, dtype=x.dtype, device=x.device)
    onehot.scatter_(1, a[:, None], 1.0)
    return onehot.T @ x


def spherical_kmeans(
    x: torch.Tensor, nlist: int, iters: int = 10, seed: int = 0
) -> torch.Tensor:
    """[nlist, D] unit-norm float32 centroids of the rows of ``x`` (on its
    device): cosine assignment, mean update, renormalise; an empty cluster
    keeps its centroid (haconvdr_tpu/index/ivf.py:46-77).  The rows of a
    cluster are summed by ``cluster_sums`` per chunk."""
    xn = _unit(x.to(torch.float32))
    idx = torch.from_numpy(np.array(init_rows(xn.shape[0], nlist, seed), np.int64))
    cent = xn[idx.to(xn.device)]
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros(nlist, dtype=torch.float32, device=xn.device)
        for r0 in range(0, xn.shape[0], ASSIGN_ROWS):
            xc = xn[r0 : r0 + ASSIGN_ROWS]
            a = torch.argmax(xc @ cent.T, dim=1)
            sums += cluster_sums(xc, a, nlist)
            counts += torch.bincount(a, minlength=nlist)
        new = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None], cent)
        cent = _unit(new)
    return cent


def _capacity(n: int, nlist: int, slack: float) -> int:
    capacity = int(np.ceil(n * slack / nlist))
    return max(8, -(-capacity // 8) * 8)


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def fill_slots(assign: np.ndarray, nlist: int, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """(in_bucket [N] bool, slot [N] int64) of the fill rule: a row's rank
    within its cluster in corpus order; rows ranked past ``capacity``
    spill to the tail in corpus order.  In-bucket slots are
    ``cluster * capacity + rank``, spill slots ``nlist * capacity +
    spill_rank``."""
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    a_sorted = assign[order]
    start = np.searchsorted(a_sorted, np.arange(nlist))
    rank = np.empty((n,), np.int64)
    rank[order] = np.arange(n, dtype=np.int64) - start[a_sorted]
    in_bucket = rank < capacity
    spill_rank = np.cumsum(~in_bucket) - 1
    slot = np.where(
        in_bucket, assign.astype(np.int64) * capacity + rank, nlist * capacity + spill_rank
    )
    return in_bucket, slot


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------

def build_ivf(
    embeddings: np.ndarray,  # [N, D] on the host
    nlist: int = 1024,
    nprobe: int = 32,
    slack: float = 1.3,
    train_rows: int = 262_144,
    kmeans_iters: int = 10,
    ids: Optional[np.ndarray] = None,
    dtype: str = "float32",
    seed: int = 0,
    device: DeviceLike = None,
) -> IVFIndex:
    """Cluster host embeddings, reorder them into equal-capacity buckets
    on ``device`` and spill the overflow to the tail
    (haconvdr_tpu/index/ivf.py:174-249).  ``capacity = ceil(N / nlist *
    slack)`` rounded up to 8 rows."""
    N, D = embeddings.shape
    if N < nlist:
        raise ValueError(f"corpus has {N} rows < nlist={nlist}")
    nprobe = min(nprobe, nlist)
    if dtype not in ("float32", "bfloat16"):
        raise ValueError("IVF stores float32/bfloat16 buckets, got " + dtype)
    dev = resolve_device(device)
    ids = np.arange(N, dtype=np.int32) if ids is None else np.asarray(ids, np.int32)
    sample = embeddings
    if N > train_rows:
        sel = np.random.RandomState(seed).choice(N, train_rows, replace=False)
        sample = embeddings[sel]
    cent = spherical_kmeans(to_torch(np.asarray(sample, np.float32), dev), nlist, kmeans_iters, seed)

    assign = np.empty((N,), np.int64)
    for s in range(0, N, ASSIGN_ROWS):
        xb = to_torch(np.asarray(embeddings[s : s + ASSIGN_ROWS], np.float32), dev)
        assign[s : s + ASSIGN_ROWS] = assign_rows(xb, cent).cpu().numpy()
    capacity = _capacity(N, nlist, slack)
    in_bucket, slot = fill_slots(assign, nlist, capacity)
    tail_rows = _round8(max(int((~in_bucket).sum()), 1))
    split = nlist * capacity
    flat = torch.zeros(split + tail_rows, D, dtype=getattr(torch, dtype), device=dev)
    flat_ids = torch.full((split + tail_rows,), -1, dtype=torch.int32, device=dev)
    for s in range(0, N, ASSIGN_ROWS):
        sl = torch.from_numpy(slot[s : s + ASSIGN_ROWS]).to(dev)
        flat[sl] = to_torch(np.asarray(embeddings[s : s + ASSIGN_ROWS], np.float32), dev, dtype)
        flat_ids[sl] = torch.from_numpy(ids[s : s + ASSIGN_ROWS]).to(dev)
    return IVFIndex(
        centroids=cent,
        buckets=flat[:split].view(nlist, capacity, D),
        bucket_ids=flat_ids[:split].view(nlist, capacity),
        tail=flat[split:],
        tail_ids=flat_ids[split:],
        nprobe=int(nprobe),
    )


def build_ivf_device(
    embeddings: torch.Tensor,  # [N, D] on the device
    nlist: int = 1024,
    nprobe: int = 32,
    slack: float = 1.3,
    tail_frac: float = 0.1,
    train_rows: int = 262_144,
    kmeans_iters: int = 10,
    ids: Optional[torch.Tensor] = None,
    seed: int = 0,
) -> IVFIndex:
    """The whole build on the embeddings' device
    (haconvdr_tpu/index/ivf.py:252-365): a stable sort by cluster, ranks
    from ``searchsorted``, and the inverse permutation gathered straight
    from the corpus, so no corpus-sized copy is made beside the buckets.
    Raises if the overflow exceeds ``tail_frac`` of N; the tail is trimmed
    to the spill."""
    N, D = embeddings.shape
    if N < nlist:
        raise ValueError(f"corpus has {N} rows < nlist={nlist}")
    nprobe = min(nprobe, nlist)
    dev = embeddings.device
    ids = (
        torch.arange(N, dtype=torch.int32, device=dev) if ids is None
        else ids.to(device=dev, dtype=torch.int32)
    )
    capacity = _capacity(N, nlist, slack)
    tail_cap = _round8(int(N * tail_frac))
    # sample before casting: an f32 copy of a bf16 corpus would double it
    if N <= train_rows:
        sample = embeddings.to(torch.float32)
    else:
        sel = torch.from_numpy(np.array(init_rows(N, train_rows, seed), np.int64))
        sample = embeddings[sel.to(dev)].to(torch.float32)
    cent = spherical_kmeans(sample, nlist, kmeans_iters, seed)
    del sample

    a = assign_rows(embeddings, cent)
    order = torch.argsort(a, stable=True)
    a_sorted = a[order]
    start = torch.searchsorted(a_sorted, torch.arange(nlist, device=dev))
    rank = torch.arange(N, device=dev) - start[a_sorted]
    in_bucket = rank < capacity
    n_spill = int((~in_bucket).sum())
    if n_spill > tail_cap:
        raise ValueError(
            f"IVF overflow: {n_spill} rows spill but tail capacity is "
            f"{tail_cap}; raise slack= or tail_frac="
        )
    spill_rank = torch.cumsum(~in_bucket, dim=0) - 1
    dest = torch.where(in_bucket, a_sorted * capacity + rank, nlist * capacity + spill_rank)
    del a, a_sorted, rank, start, spill_rank
    # the tail keeps only its used prefix: every query scans all of it
    split = nlist * capacity
    total = split + _round8(n_spill)
    src = torch.full((total,), -1, dtype=torch.int64, device=dev)
    src[dest] = order

    def take(s):
        v = s >= 0
        rows = embeddings[s.clamp_min(0)]
        rows[~v] = 0
        return rows, torch.where(v, ids[s.clamp_min(0)], -1)

    buckets, bucket_ids = take(src[:split])
    tail, tail_ids = take(src[split:])
    return IVFIndex(
        centroids=cent,
        buckets=buckets.view(nlist, capacity, D),
        bucket_ids=bucket_ids.view(nlist, capacity),
        tail=tail,
        tail_ids=tail_ids,
        nprobe=int(nprobe),
    )


# ---------------------------------------------------------------------------
# int8 quantization
# ---------------------------------------------------------------------------

def scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """Per-dimension scale ``amax / 127`` (1 where amax is 0), computed as
    ``amax * float32(1 / 127)``: XLA compiles JAX's ``amax / 127.0`` inside
    ``quantize_ivf``'s jit that way, and the two differ by an ulp at some
    values (the store build's scales are made outside a jit, with a
    division: parallel/sharded_ivf.py)."""
    return torch.where(amax > 0, amax * np.float32(1.0 / 127.0), torch.ones_like(amax))


def encode_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8, with an IEEE division
    as the JAX package's ``encode_int8`` (haconvdr_tpu/index/quantize.py:66-72)."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)


def _cluster_chunk(index: IVFIndex) -> int:
    _, cap, D = index.buckets.shape
    return max(1, PANEL_BYTES // (cap * D * 4))


def quantize_ivf(index: IVFIndex, by_residual: bool = True) -> IVFIndex:
    """int8 buckets on the index's device (haconvdr_tpu/index/ivf.py:105-171).

    ``by_residual=False``: one [D] scale from the amax of every bucket and
    tail row.  ``by_residual=True`` (default): buckets hold codes of
    ``row - mean(cluster)`` with per-cluster [nlist, D] scales, the tail
    codes of ``row - mean(corpus)`` with its own [D] ``tail_scale``; the
    means are float32 sums over the valid rows.  An index that is already
    int8 is returned as it is."""
    if index.scale is not None:
        return index
    nlist = index.buckets.shape[0]
    step = _cluster_chunk(index)
    tail = index.tail.to(torch.float32)
    if not by_residual:
        amax = tail.abs().amax(dim=0)
        for c0 in range(0, nlist, step):
            amax = torch.maximum(amax, index.buckets[c0 : c0 + step].to(torch.float32)
                                 .abs().amax(dim=(0, 1)))
        scale = scale_from_amax(amax)
        b8 = torch.empty(index.buckets.shape, dtype=torch.int8, device=index.buckets.device)
        for c0 in range(0, nlist, step):
            b8[c0 : c0 + step] = encode_int8(index.buckets[c0 : c0 + step], scale)
        return index._replace(buckets=b8, tail=encode_int8(tail, scale), scale=scale)

    b8 = torch.empty(index.buckets.shape, dtype=torch.int8, device=index.buckets.device)
    means = torch.empty(nlist, index.buckets.shape[2], device=index.buckets.device)
    scale = torch.empty_like(means)
    total = torch.zeros_like(means[0])
    n_valid = 0
    for c0 in range(0, nlist, step):
        valid = (index.bucket_ids[c0 : c0 + step] >= 0)[..., None]
        bf = index.buckets[c0 : c0 + step].to(torch.float32) * valid
        cnt = torch.clamp_min(valid.sum(dim=1).to(torch.float32), 1.0)
        m = bf.sum(dim=1) / cnt
        res = (bf - m[:, None, :]) * valid  # pad rows stay 0
        s = scale_from_amax(res.abs().amax(dim=1))
        means[c0 : c0 + step], scale[c0 : c0 + step] = m, s
        b8[c0 : c0 + step] = encode_int8(res, s[:, None, :])
        total += bf.sum(dim=(0, 1))
        n_valid += int(valid.sum())
    valid_t = (index.tail_ids >= 0)[:, None]
    tf = tail * valid_t
    mu = (total + tf.sum(dim=0)) / max(n_valid + int(valid_t.sum()), 1)
    res_t = (tf - mu) * valid_t
    tail_scale = scale_from_amax(res_t.abs().amax(dim=0))
    return index._replace(
        buckets=b8, tail=encode_int8(res_t, tail_scale), scale=scale, means=means, mu=mu,
        tail_scale=tail_scale,
    )


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _fold(qf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 scoring model's query: ``q * scale`` rounded to bfloat16,
    widened back (exact) so int8 codes times it are exact float32 products."""
    return (qf * scale).to(torch.bfloat16).to(torch.float32)


def _top(keys, ids, k):
    pos = torch.topk(keys, min(k, keys.shape[1]), dim=1).indices
    return torch.gather(keys, 1, pos), torch.gather(ids, 1, pos)


def probe_clusters(centroids: torch.Tensor, qf: torch.Tensor, nprobe: int) -> torch.Tensor:
    """[Q, nprobe] global cluster ids of each query's top ``nprobe``
    centroids (cosine), best first, ties to the lower cluster."""
    nlist = centroids.shape[0]
    ckeys = order_keys(_unit(qf) @ centroids.T, torch.arange(nlist, device=qf.device)[None, :])
    return torch.topk(ckeys, nprobe, dim=1).indices


def ivf_candidates(
    index: IVFIndex, qf: torch.Tensor, probe: torch.Tensor, k: int, lo: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys [Q, <= k], ids [Q, <= k]) of the best candidates among the
    probed buckets ``index`` holds and its tail, keys ordered (score desc,
    position asc) over probe rank, then the tail.

    ``index`` is a whole index, or one shard of a sharded one: its buckets
    are the clusters ``[lo, lo + len(buckets))`` and its tail a slice of
    the spill, while ``probe`` ([Q, nprobe]) and the sidecars (per-cluster
    scales, cluster means) stay global.  A shard scores only the probes
    it owns and reports the others as empty slots, as each shard of the
    JAX package's sharded search does
    (haconvdr_tpu/parallel/sharded_ivf.py:107-168).  Queries go in
    batches, and a batch's probes in groups, so no more than
    ``PANEL_BYTES`` of float32 bucket rows are scored at once."""
    buckets = index.buckets
    per, cap, D = buckets.shape
    dev = buckets.device
    Q, nprobe = probe.shape
    n_tail = index.tail.shape[0]
    pool = nprobe * cap + n_tail
    if index.centroids.shape[0] == per:  # every cluster is here
        rank = own = None
        local = gprobe = probe
        m = nprobe
    else:  # this shard's probes first, in probe order, then the others masked
        owned = (probe >= lo) & (probe < lo + per)
        m = int(owned.sum(dim=1).max()) if Q else 0
        rank = torch.argsort((~owned).to(torch.uint8), dim=1, stable=True)[:, :m]
        own = torch.gather(owned, 1, rank)
        gprobe = torch.gather(probe, 1, rank)
        local = torch.where(own, gprobe - lo, 0)
    scale, means = index.scale, index.means
    if scale is None:
        qb = qf.to(buckets.dtype).to(torch.float32)
    elif scale.dim() == 1:
        qb = _fold(qf, scale)
    else:
        qb = None  # per-cluster scales: folded per probe
    cm = None if means is None else qf @ means.T  # [Q, nlist]
    qb_t = qb if index.tail_scale is None else _fold(qf, index.tail_scale)
    tail_s = qb_t @ index.tail.to(torch.float32).T  # [Q, tail]
    if index.mu is not None:
        tail_s = tail_s + (qf @ index.mu)[:, None]
    tail_s = torch.where(index.tail_ids[None, :] >= 0, tail_s, float("-inf"))
    tail_keys = order_keys(tail_s, torch.arange(nprobe * cap, pool, device=dev)[None, :])

    row_bytes = cap * D * 4
    qstep = max(1, PANEL_BYTES // (max(m, 1) * row_bytes))
    out_keys, out_ids = [], []
    for q0 in range(0, Q, qstep):
        b = min(qstep, Q - q0)
        best = None
        pstep = max(1, min(m, PANEL_BYTES // (b * row_bytes)))
        for p0 in range(0, m, pstep):
            p = local[q0 : q0 + b, p0 : p0 + pstep]  # [b, g]
            gp = gprobe[q0 : q0 + b, p0 : p0 + pstep]
            g = p.shape[1]
            panel = buckets.index_select(0, p.reshape(-1)).to(torch.float32)
            if qb is not None:
                qp = qb[q0 : q0 + b, None, :].expand(b, g, D)
            else:
                qp = _fold(qf[q0 : q0 + b, None, :], scale[gp])
            s = torch.bmm(panel, qp.reshape(b * g, D, 1)).view(b, g, cap)
            del panel
            if cm is not None:
                s = s + torch.gather(cm[q0 : q0 + b], 1, gp)[:, :, None]
            ids = index.bucket_ids[p]  # [b, g, cap]
            if own is None:
                pos = torch.arange(p0 * cap, (p0 + g) * cap, device=dev)[None, :]
            else:
                ids = torch.where(own[q0 : q0 + b, p0 : p0 + g, None], ids, -1)
                pos = (rank[q0 : q0 + b, p0 : p0 + g, None] * cap
                       + torch.arange(cap, device=dev)).view(b, g * cap)
            ids = ids.view(b, g * cap)
            s = torch.where(ids >= 0, s.view(b, g * cap), float("-inf"))
            cand = _top(order_keys(s, pos), ids, k)
            if best is not None:
                cand = _top(torch.cat([best[0], cand[0]], 1), torch.cat([best[1], cand[1]], 1), k)
            best = cand
        tk = tail_keys[q0 : q0 + b]
        tail_ids = index.tail_ids[None, :].expand(b, -1)
        if best is None:
            best = _top(tk, tail_ids, k)
        else:
            best = _top(torch.cat([best[0], tk], 1), torch.cat([best[1], tail_ids], 1), k)
        out_keys.append(best[0])
        out_ids.append(best[1])
    return torch.cat(out_keys), torch.cat(out_ids)


def ivf_search_device(
    index: IVFIndex, queries: torch.Tensor, k: int, nprobe: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] float32, ids [Q, k] int32) on the index's device,
    exact over each query's ``nprobe`` probed buckets and the tail
    (haconvdr_tpu/index/ivf.py:368-452).

    Every score is float32: bfloat16 buckets and the bfloat16-cast query
    are widened before the product (exact), int8 codes meet the query
    folded by its scale and rounded to bfloat16, residual codes get the
    exact ``q . mean`` back per probed cluster (``q . mu`` on the tail).
    Candidates are ordered (score desc, position asc) over probe rank,
    then the tail, as ``lax.top_k`` breaks ties; empty slots are (-inf, -1)
    (:func:`ivf_candidates`)."""
    _, cap, _ = index.buckets.shape
    pool = nprobe * cap + index.tail.shape[0]
    if k > pool:
        raise ValueError(
            f"k={k} exceeds the {pool} candidates of {nprobe} probed buckets of "
            f"{cap} rows and the {index.tail.shape[0]}-row tail"
        )
    qf = queries.to(device=index.buckets.device, dtype=torch.float32)
    keys, ids = ivf_candidates(index, qf, probe_clusters(index.centroids, qf, nprobe), k)
    scores, _ = decode_keys(keys)
    return scores, ids.to(torch.int32)


def ivf_search(
    index: IVFIndex, queries, k: int = 100, nprobe: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """numpy (scores [Q, k], global ids [Q, k]); exact over the probed
    buckets and the tail.  ``nprobe`` defaults to the index's and is
    clamped to nlist."""
    nprobe = index.nprobe if nprobe is None else nprobe
    nprobe = min(nprobe, index.centroids.shape[0])
    q = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(queries, np.float32))
    s, i = ivf_search_device(index, q, k, nprobe)
    return to_numpy(s), to_numpy(i)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def save_ivf(index: IVFIndex, dir_path: str) -> None:
    """Persist an IVF index as ``.npy`` arrays and ``ivf_meta.json``
    (haconvdr_tpu/index/ivf.py:455-478); sidecars of an earlier int8 save
    that this index lacks are removed."""
    os.makedirs(dir_path, exist_ok=True)
    for name in ARRAYS:
        save_npy(os.path.join(dir_path, name + ".npy"), getattr(index, name))
    for name in SIDECARS:
        path = os.path.join(dir_path, name + ".npy")
        val = getattr(index, name)
        if val is not None:
            save_npy(path, val)
        elif os.path.exists(path):
            # a loaded float index with a stale scale would fold it into scores
            os.remove(path)
    with open(os.path.join(dir_path, "ivf_meta.json"), "w") as f:
        json.dump({"nprobe": index.nprobe, "version": 1}, f)


def load_ivf(dir_path: str, device: DeviceLike = None) -> IVFIndex:
    """Inverse of :func:`save_ivf` (either package's), onto ``device``."""
    dev = resolve_device(device)
    with open(os.path.join(dir_path, "ivf_meta.json")) as f:
        meta = json.load(f)

    def opt(name):
        path = os.path.join(dir_path, name + ".npy")
        return load_npy(path, dev) if os.path.exists(path) else None

    return IVFIndex(
        nprobe=int(meta["nprobe"]),
        **{name: load_npy(os.path.join(dir_path, name + ".npy"), dev) for name in ARRAYS},
        **{name: opt(name) for name in SIDECARS},
    )
