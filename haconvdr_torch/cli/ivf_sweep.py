"""CLI: IVF recall/latency tuning sweep (counterpart of
haconvdr_tpu/cli/ivf_sweep.py), on one device.

Point it at an embedding matrix (.npy) or an EmbeddingBlockStore
directory plus a query matrix: it builds one IVF index per (nlist, slack)
with ``build_ivf_device`` and sweeps nprobe, one JSON row per
configuration with recall@k against the exact flat search
(``ops/topk.BlockSearcher``, the v4 and v3 kernels on the card),
per-query latency, the bucket memory overhead and the scanned fraction.

    python -m haconvdr_torch.cli.ivf_sweep \
        embeddings=emb.npy queries=q.npy \
        nlist=1024,4096 nprobe=8,16,32,64 slack=1.3 k=100 out=sweep.jsonl \
        [dtype=bfloat16|float32|int8 rescore_oversample=0] [--device cuda|cpu]

With no ``queries=``, a strided sample of the corpus itself is used.
``dtype=int8`` builds bfloat16 buckets and quantizes them
(``quantize_ivf``, residual codes).  ``rescore_oversample`` > 1 adds a
``recall_two_stage`` column: ``oversample * k`` candidates (clamped to the
candidate pool) reranked by exact float scores.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import List

import numpy as np
import torch

from haconvdr_torch.cli._args import pop_device
from haconvdr_torch.device import DeviceLike, resolve_device, to_torch
from haconvdr_torch.index.ivf import build_ivf_device, ivf_search, quantize_ivf
from haconvdr_torch.index.store import EmbeddingBlockStore
from haconvdr_torch.ops.topk import BlockSearcher
from haconvdr_torch.utils.io import load_npy, parse_kv_args, setup_logging

logger = logging.getLogger(__name__)


def _load_embeddings(spec: str) -> np.ndarray:
    if os.path.isdir(spec):
        store = EmbeddingBlockStore.open_auto(spec)
        return np.concatenate([np.asarray(e, np.float32) for e, _ in store.iter_blocks()])
    return load_npy(spec, torch.device("cpu")).to(torch.float32).numpy()


def sweep(
    embeddings: np.ndarray,
    queries: np.ndarray,
    nlists: List[int],
    nprobes: List[int],
    slacks: List[float],
    k: int = 100,
    dtype: str = "bfloat16",
    seed: int = 0,
    latency_reps: int = 3,
    rescore_oversample: float = 0.0,
    device: DeviceLike = None,
) -> List[dict]:
    """One row per (nlist, slack, nprobe), with JAX's keys
    (haconvdr_tpu/cli/ivf_sweep.py:54-168); a build that overflows its
    tail records an ``error`` row and the sweep goes on."""
    dev = resolve_device(device)
    N = embeddings.shape[0]
    queries = np.asarray(queries, np.float32)
    _, gt_i = BlockSearcher(top_k=k, device=dev).search(
        queries, [(embeddings, np.arange(N, dtype=np.int64))]
    )
    gt_sets = [set(row[row >= 0].tolist()) for row in gt_i]

    rows = []
    int8 = dtype == "int8"  # quantized buckets: built at bf16, then quantize_ivf
    x = to_torch(np.asarray(embeddings, np.float32), dev, "bfloat16" if int8 else dtype)
    for nlist in nlists:
        if nlist > N:
            logger.warning("skipping nlist=%d > corpus %d", nlist, N)
            continue
        for slack in slacks:
            t0 = time.time()
            try:
                index = build_ivf_device(
                    x, nlist=nlist, nprobe=max(nprobes), slack=slack,
                    tail_frac=min(0.5, 4.0 / slack / nlist + 0.1), seed=seed,
                )
            except ValueError as e:
                rows.append({"nlist": nlist, "slack": slack, "error": str(e)})
                logger.warning("nlist=%d slack=%.2f: %s", nlist, slack, e)
                continue
            if int8:
                index = quantize_ivf(index)
            build_s = time.time() - t0
            cap = index.buckets.shape[1]
            bucket_rows = index.buckets.shape[0] * cap
            tail_rows = index.tail.shape[0]
            for nprobe in sorted(nprobes):
                _, i = ivf_search(index, queries, k=k, nprobe=nprobe)
                recall = float(np.mean([
                    len(set(i[r].tolist()) & gt_sets[r]) / max(1, len(gt_sets[r]))
                    for r in range(len(queries))
                ]))
                recall2 = None
                if rescore_oversample > 1.0:
                    # clamp to the candidate pool: probed buckets + tail
                    pool = min(nprobe, index.buckets.shape[0]) * cap + tail_rows
                    m = min(int(np.ceil(k * rescore_oversample)), pool)
                    _, ci = ivf_search(index, queries, k=m, nprobe=nprobe)
                    r2 = []
                    for r in range(len(queries)):
                        cand = ci[r][ci[r] >= 0]
                        ex = queries[r] @ embeddings[cand].T
                        top = cand[np.argsort(-ex, kind="stable")[:k]]
                        r2.append(len(set(top.tolist()) & gt_sets[r]) / max(1, len(gt_sets[r])))
                    recall2 = round(float(np.mean(r2)), 4)
                t0 = time.time()
                for _ in range(latency_reps):
                    ivf_search(index, queries, k=k, nprobe=nprobe)
                lat = (time.time() - t0) / latency_reps / len(queries)
                rows.append({
                    "nlist": nlist, "nprobe": nprobe, "slack": slack,
                    "k": k, "dtype": dtype,
                    "recall_at_k": round(recall, 4),
                    **(
                        {"recall_two_stage": recall2, "rescore_oversample": rescore_oversample}
                        if recall2 is not None else {}
                    ),
                    "latency_ms_per_query": round(lat * 1000.0, 4),
                    "build_s": round(build_s, 2),
                    "memory_overhead": round((bucket_rows + tail_rows) / N, 3),
                    "scanned_frac": round((nprobe * cap + tail_rows) / N, 4),
                })
                logger.info("%s", rows[-1])
    return rows


def main(argv=None):
    setup_logging()
    device, argv = pop_device(argv)
    dev = resolve_device(device)  # raises without the card before any read
    args = parse_kv_args(argv)
    emb = _load_embeddings(args["embeddings"])
    if "queries" in args:
        q = np.asarray(np.load(args["queries"]), np.float32)
    else:
        n_q = int(args.get("n_queries", "256"))
        q = emb[:: max(1, emb.shape[0] // n_q)][:n_q].copy()
    rows = sweep(
        emb,
        q,
        nlists=[int(v) for v in args.get("nlist", "1024").split(",")],
        nprobes=[int(v) for v in args.get("nprobe", "8,32,64").split(",")],
        slacks=[float(v) for v in args.get("slack", "1.3").split(",")],
        k=int(args.get("k", "100")),
        dtype=args.get("dtype", "bfloat16"),
        seed=int(args.get("seed", "0")),
        rescore_oversample=float(args.get("rescore_oversample", "0")),
        device=dev,
    )
    out = args.get("out", "ivf_sweep.jsonl")
    with open(out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    logger.info("wrote %d rows to %s", len(rows), out)
    ok = [r for r in rows if "recall_at_k" in r]  # not the overflow rows
    best = max(ok, key=lambda r: (r["recall_at_k"], -r["latency_ms_per_query"]))
    print(json.dumps({"best": best}))
    return rows


if __name__ == "__main__":
    main()
