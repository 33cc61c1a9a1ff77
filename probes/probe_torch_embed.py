"""The port's f32 query tower: one batch of 64 requests through
``Retriever.embed``, timed as ``chip_smoke.py`` phase 4 times it.

Run on a CUDA card from the root of the checkout to measure (its own
``haconvdr_torch`` and ``chip_smoke.py`` are imported, so two checkouts
can be compared in one session, each from its own root):

    python3 <repo>/probes/probe_torch_embed.py [--seed 0] [--reps 5]

Full-width ANCE RoBERTa-base (the ``ModelConfig`` defaults) with random
weights from the seed, the requests of ``chip_smoke.make_requests``, and a
100,000-row random f32 index (the embed does not read it).  Two warm-up
embeds, then ``--reps`` timed ones on a CUDA-synchronized host clock; it
prints their median and every sample, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_embed: no CUDA card", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.models.convert import init_params_numpy

    dev = torch.device("cuda")
    cfg = ModelConfig()
    params = init_params_numpy(cfg, args.seed)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    store = torch.randn(100_000, cs.DIM, device=dev, generator=g)
    retriever = cs.build_retriever(params, cfg, dev, store, None)
    reqs = cs.make_requests(args.seed, cs.N_BATCHED + cs.N_SINGLE)
    examples = [retriever.build_query(*r) for r in reqs][:64]
    for _ in range(2):
        retriever.embed(examples)
    samples = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        retriever.embed(examples)
        samples.append((time.perf_counter() - t) * 1e3)
    print(f"f32 tower embed: B 64 in {float(np.median(samples)):.2f} ms (median of {samples}) "
          f"[{cs.card_line()}] [{os.getcwd()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
