"""Where the int8 tower's CUDA path parts from the reference: the port's
tower through its CUDA kernels and through its plain twins (``plain=True``,
plain PyTorch on the same card), and the reference's int8 arithmetic, on the
same token ids, cut after each depth in ``--depths``:

    python3 h100_bench/witness.py --workload int8-sessions-open --seed <n> \
        --depths 1,2,3,6,12 --requests 64

A line a depth: the largest relative distance between the embeddings
(|a - b| / |b| over the requests) of each pair of the three.  The requests
are the cell's first ones, padded to the configuration's length.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def distances(a, b) -> dict:
    d = (a.double() - b.double()).norm(dim=1) / b.double().norm(dim=1)
    return {"max": float(d.max()), "median": float(d.median())}


def readings(cell, seed: int, depths, requests: int, device):
    """A dict a depth: the three pairs' distances."""
    import numpy as np
    import torch

    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params

    from h100_bench.harness import inputs
    from h100_bench.harness import traffic as gen
    from h100_bench.harness.port import port_config
    from h100_bench.reference.embed import Reference
    from h100_bench.reference.query import convqp_ids
    from h100_bench.reference.tokenizer import HashWordTokenizer

    config = cell.config
    sess = gen.Sessions(cell.traffic, seed)
    tok, L = HashWordTokenizer(config["vocab_size"]), config["max_concat_length"]
    ids = np.zeros((requests, L), np.int64)
    mask = np.zeros_like(ids)
    for j in range(requests):
        row, n = convqp_ids(tok, *sess.request(j), max_concat=L)
        ids[j], mask[j, :n] = row, 1
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    params = inputs.make_params(config, seed, device)
    for depth in depths:
        conf = dict(config, num_hidden_layers=depth)
        p = dict(params, layers=params["layers"][:depth])
        out = {}
        for name, plain in (("cuda", False), ("plain", True)):
            q = quantize_encoder_params(p) if config["tower"]["int8"] else p
            enc = AnceEncoder.from_jax_params(q, port_config(conf), device, plain=plain)
            with torch.inference_mode():
                out[name] = enc(ids_t.to(device), mask_t.to(device)).float()
            del enc, q
        out["reference"] = Reference(conf, p, device).embed(ids_t, mask_t).float()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield {"workload": cell.name, "seed": seed, "depth": depth,
               "cuda_vs_reference": distances(out["cuda"], out["reference"]),
               "plain_vs_reference": distances(out["plain"], out["reference"]),
               "cuda_vs_plain": distances(out["cuda"], out["plain"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the int8 tower's CUDA path against its twins")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--depths", default="1,2,3,6,12")
    ap.add_argument("--requests", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    from h100_bench.harness.cell import load_cell

    if not torch.cuda.is_available():
        print("witness.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    depths = [int(d) for d in args.depths.split(",")]
    for line in readings(cell, args.seed, depths, args.requests, torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
