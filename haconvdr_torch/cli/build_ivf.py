"""CLI: build the IVF serving index offline and persist it (counterpart of
haconvdr_tpu/cli/build_ivf.py), on the mesh of ``--device``.

Usage:
  python -m haconvdr_torch.cli.build_ivf embeddings=<block store dir> \
      out=<ivf artifact dir> [nlist=4096 nprobe=64 slack=1.3 \
      dtype=bfloat16|int8|float32 train_rows=262144 kmeans_iters=10 \
      seed=0 num_blocks=-1 chunk_rows=65536 by_residual=1] [--device cuda|cpu]

Streams the store through ``parallel/sharded_ivf.build_ivf_from_store``
onto the mesh of ``--device`` (every visible CUDA card by default, one
shard a card, refusing to start without one; ``--device cpu`` one CPU
shard; the shard count must divide nlist) and writes the sharded artifact
directory with ``save_ivf_sharded``, which ``Retriever(ivf=True,
ivf_dir=out)`` of either package reloads onto any mesh whose shard count
divides nlist.  Prints one JSON line with the build stats;
``main`` returns (index, stats).
"""

import json
import logging
import time

import torch

from haconvdr_torch.cli._args import device_mesh, pop_device
from haconvdr_torch.index.ivf import DTYPE_NAMES, IVFIndex
from haconvdr_torch.index.store import EmbeddingBlockStore
from haconvdr_torch.parallel.sharded_ivf import build_ivf_from_store, save_ivf_sharded
from haconvdr_torch.utils.io import parse_kv_args, setup_logging

logger = logging.getLogger(__name__)


def main(argv=None):
    setup_logging()
    device, argv = pop_device(argv)
    mesh = device_mesh(device)  # raises without the card before any read
    args = parse_kv_args(argv)
    if "embeddings" not in args or "out" not in args:
        raise SystemExit(__doc__)
    store = EmbeddingBlockStore.open_auto(args["embeddings"])
    t0 = time.time()
    index = build_ivf_from_store(
        mesh,
        store,
        nlist=int(args.get("nlist", "4096")),
        nprobe=int(args.get("nprobe", "64")),
        slack=float(args.get("slack", "1.3")),
        train_rows=int(args.get("train_rows", "262144")),
        kmeans_iters=int(args.get("kmeans_iters", "10")),
        dtype=args.get("dtype", "bfloat16"),
        seed=int(args.get("seed", "0")),
        num_blocks=int(args.get("num_blocks", "-1")),
        chunk_rows=int(args.get("chunk_rows", "65536")),
        by_residual=args.get("by_residual", "1") not in ("0", "false", "False"),
    )
    for dev in mesh.distinct:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    build_s = time.time() - t0
    t0 = time.time()
    save_ivf_sharded(index, args["out"])
    shards = [index] if isinstance(index, IVFIndex) else index.shards
    stats = {
        "out": args["out"],
        "nlist": int(index.centroids.shape[0]),
        "capacity": int(shards[0].buckets.shape[1]),
        "dim": int(shards[0].buckets.shape[2]),
        "tail_rows": sum(int(sh.tail.shape[0]) for sh in shards),
        "dtype": DTYPE_NAMES[shards[0].buckets.dtype],
        "n_shards": 1 if isinstance(index, IVFIndex) else index.n_shards,
        "build_s": round(build_s, 2),
        "save_s": round(time.time() - t0, 2),
    }
    logger.info("%s", stats)
    print(json.dumps(stats))
    return index, stats


if __name__ == "__main__":
    main()
