"""Serving per stage, as PERF.md section 5 tabulates it: build_query, the
tower's embed and the index search, for one request (B 1) and a batch of
64, and the card's idle share over one embed + search.

    python3 probes/probe_torch_serve_stages.py [--seed 0]

Run from a checkout's root.  It uses only what chip_smoke.py's serving
phases use (build_retriever, make_requests, profile_window), so an earlier
checkout runs it as well (``cd DIR && python3 <this checkout>/probes/
probe_torch_serve_stages.py``) for a comparison in one call.  Over
chip_smoke.py's 2,500,000 x 768 index (random from the seed), full-width
ANCE RoBERTa-base towers (random weights from the seed): the f32 tower over
the f32 index, the int8 bf16 tower over the same index, and the f32 tower
over the int8 index.  Host ms, medians of 5 (each stage synchronized: embed
and search hand back host arrays); idle share = 1 - kernel time / wall time
of one embed + search under torch.profiler.  Every line carries the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402

REPS = 5


def median_ms(fn) -> float:
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_serve_stages: needs a CUDA card", file=sys.stderr)
        return 2
    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.device import resolve_device
    from haconvdr_torch.models.convert import init_params_numpy

    card = cs.card_line()
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    passages = torch.randn(cs.N_ROWS, cs.DIM, device=dev, generator=g)
    cfg = ModelConfig()
    params = init_params_numpy(cfg, args.seed)
    reqs = cs.make_requests(args.seed, 64)
    setups = (
        ("f32 tower", cfg, {}),
        ("int8 bf16 tower", dataclasses.replace(cfg, dtype="bfloat16"), {"encoder_int8": True}),
        ("f32 tower, int8 index", cfg, {"store_dtype": "int8"}),
    )
    for name, c, kw in setups:
        r = cs.build_retriever(params, c, dev, passages, None, **kw)
        r.index.search(r.embed([r.build_query(*reqs[0])]), cs.TOP_K)  # warm-up
        for B in (1, 64):
            ex = [r.build_query(*q) for q in reqs[:B]]
            emb = r.embed(ex)
            build_ms = median_ms(lambda: [r.build_query(*q) for q in reqs[:B]])
            embed_ms = median_ms(lambda: r.embed(ex))
            search_ms = median_ms(lambda: r.index.search(emb, cs.TOP_K))
            wall, dev_ms, _ = cs.profile_window(lambda: r.index.search(r.embed(ex), cs.TOP_K), 1)
            print(f"serve stages [{name}] B {B}: build_query {build_ms:.2f} ms, embed "
                  f"{embed_ms:.2f} ms, search {search_ms:.2f} ms; device idle "
                  f"{1 - dev_ms / wall:.1%} ({dev_ms:.2f} ms kernels in {wall:.2f} ms; "
                  f"{Path.cwd().name}) [{card}]", flush=True)
        del r
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
