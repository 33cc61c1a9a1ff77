"""IVF on the card over Gaussian mixtures: for each mixture, the tail its
build leaves and recall@100 of nprobe 4-64 against the flat bf16 search,
with the search's ms at Q 1; then, over the last mixture, how one search
reaches the card at Q 1, 8 and 64 and whether chip_smoke.py's
``device_ms`` (calls queued behind a spin of the card) can time it.

    python3 probes/probe_torch_ivf.py [--seed 0] [--mixtures 4096:0.04,64:0.06]

Run from a checkout's root.  Each mixture is MODES:NOISE, 2,500,000 x 768
rows from ``chip_smoke.ivf_corpus`` (MODES unit-norm modes plus N(0,
NOISE^2) per dimension) with its 256 queries; bfloat16 buckets from
``build_ivf_device`` at nlist 1024, nprobe 32, slack 1.3 (chip_smoke.py
phase 13 builds through ``cli/build_ivf``, whose strided k-means sample
differs, so its tail differs a little).  Per Q of the last mixture: device
operations per call, host ms to enqueue a call, CUDA-event ms of calls back
to back, torch.profiler's device ms, the allocator's device mallocs, frees
and syncs over ten calls, the synchronizing calls that
``torch.cuda.set_sync_debug_mode`` reports, and ``device_ms`` at 10 and 2
calls.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402

PROBES = (4, 8, 16, 32, 64)
QS = (1, 8, 64)


def mixture_row(seed: int, dev, n_modes: int, noise: float, card: str):
    from haconvdr_torch.index import ivf
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    rows, mq = cs.ivf_corpus(seed, dev, n_modes, noise)
    flat = ShardedIndex.from_tensor(rows, dtype="bfloat16")
    _, gt = flat.search(mq, cs.TOP_K)
    flat_q1 = cs.cuda_ms(lambda: flat.search_device(mq[:1], cs.TOP_K), 10)
    del flat
    rows16 = rows.to(torch.bfloat16)
    del rows
    torch.cuda.empty_cache()
    t = time.perf_counter()
    idx = ivf.build_ivf_device(rows16, nlist=cs.IVF_NLIST, nprobe=cs.IVF_NPROBE,
                               tail_frac=0.5, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    del rows16
    torch.cuda.empty_cache()
    row = {
        "modes": n_modes, "noise": noise, "build_s": build_s,
        "tail_rows": int((idx.tail_ids >= 0).sum()),
        "empty_slots": int((idx.bucket_ids < 0).sum()),
        "recall_at_100": {p: cs.recall_at(ivf.ivf_search(idx, mq, k=cs.TOP_K, nprobe=p)[1], gt)
                          for p in PROBES},
        "q1_events_ms": {
            "ivf": cs.cuda_ms(lambda: ivf.ivf_search_device(idx, mq[:1], cs.TOP_K,
                                                            cs.IVF_NPROBE), 10),
            "flat_bf16": flat_q1},
    }
    print("ivf mixture:", json.dumps(row), f"[{card}]", flush=True)
    return idx, mq


def search_reach(idx, mq, card: str) -> None:
    from haconvdr_torch.index import ivf

    for Q in QS:
        q = mq[:Q]

        def fn():
            return ivf.ivf_search_device(idx, q, cs.TOP_K, cs.IVF_NPROBE)

        fn()
        torch.cuda.synchronize()
        before = cs.alloc_counts()
        t = time.perf_counter()
        for _ in range(10):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3 / 10
        torch.cuda.synchronize()
        row = {"Q": Q, "host_enqueue_ms": host_ms, "alloc_over_10_calls": cs.alloc_delta(before)}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            fn()
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        row["sync_warnings"] = [str(w.message)[:120] for w in caught
                                if "synchroniz" in str(w.message).lower()]
        row["events_ms"] = cs.cuda_ms(fn, 10)
        row["profiler_wall_ms"], row["profiler_device_ms"], row["device_ops"] = (
            cs.profiled_ms(fn, 10))
        for reps in (10, 2):
            before = cs.alloc_counts()
            try:
                row[f"device_ms_{reps}"] = cs.device_ms(fn, reps)
            except RuntimeError as e:
                row[f"device_ms_{reps}"] = str(e)
            row[f"device_ms_{reps}_alloc"] = cs.alloc_delta(before)
        print("ivf search reach:", json.dumps(row), f"[{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mixtures", default="4096:0.04,64:0.06")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_ivf: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    idx = mq = None
    for spec in args.mixtures.split(","):
        modes, noise = spec.split(":")
        del idx, mq
        torch.cuda.empty_cache()
        idx, mq = mixture_row(args.seed, dev, int(modes), float(noise), card)
    search_reach(idx, mq, card)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
