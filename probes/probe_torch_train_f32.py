"""f32 training micro steps at configs/topiocqa_train.toml's geometry, timed
as ``chip_smoke.py`` phase 11 times them.

Run on a CUDA card from the root of the checkout to measure: the
working directory's ``haconvdr_torch``, ``chip_smoke.py`` and
``configs/topiocqa_train.toml`` are the ones used, so two checkouts can be
compared in one session, each from its own root:

    python3 <repo>/probes/probe_torch_train_f32.py [--seed 0] [--micro 8]

The TOML read through the port's ``load_config`` (f32 trained and frozen
towers, ``remat = "mlp"``, dropout 0.1, B 64, query 512, passages 384,
``is_prepos_neg``: three frozen forwards a micro step), cut to
accumulation 2 and ``chip_smoke.TRAIN_LR``, on random weights from the
seed through ``chip_smoke.train_setup`` (as phase 11 calls it) and
``chip_smoke.train_batch``'s batch.  Two warm-up micro steps,
then the rest timed on a CUDA-synchronized host clock; it prints
examples/s over the timed steps, the median step, every step's ms, the
flash kernels' launches and peak memory, with the card's name and power
limit.  It uses only what the port had before phase 11 existed, so it
runs from an older checkout too.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--micro", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_train_f32: no CUDA card", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from haconvdr_torch.config import load_config
    from haconvdr_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    exp = load_config(os.path.join(os.getcwd(), "configs", "topiocqa_train.toml"))
    cfg = exp.model
    tcfg = dataclasses.replace(exp.train, accumulation_steps=2, learning_rate=cs.TRAIN_LR)
    step, state, frozen = cs.train_setup(args.seed + 70, dev, cfg, tcfg)
    batch = cs.train_batch(args.seed + 80, tcfg.per_device_train_batch_size, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.COUNTS)
    secs = []
    for _ in range(args.micro):
        t = time.perf_counter()
        _, loss = step(state, frozen, batch)
        float(loss)  # a host sync: the step has finished
        secs.append(time.perf_counter() - t)
    timed = secs[2:]
    n = tcfg.per_device_train_batch_size
    launches = {k: fa.COUNTS[k] - before[k] for k in fa.COUNTS}
    print(f"train-f32 ({cfg.dtype} towers, B {n}): {n * len(timed) / sum(timed):.2f} examples/s "
          f"over {len(timed)} micro steps, median {float(np.median(timed)) * 1e3:.1f} ms "
          f"(steps {[round(s * 1e3, 1) for s in secs]} ms), flash launches {launches}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{cs.card_line()}] "
          f"[{os.getcwd()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
