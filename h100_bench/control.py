"""The control of a cell's check: the reference one precision step below
the configuration's (float32: TF32 on; int8: int4) put in the port's
place, at the cell's own size, on several seeds in one process:

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3

It prints, a line a seed, ``correct`` as a run's check (``check.judge``)
decides it over the control's numbers, and each number beside its limit:
the control has to come out not correct.  A serving
cell's control answers the same sample of requests a run checks (drawn
from the mix's first requests, the longest among them) with its own
embeddings and its own search; a corpus cell's control stores the int4
tower's rows coded in int4.  No window runs: the control serves nothing.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CANDIDATES = 4096  # requests (or passages) a sample is drawn from


def serve_numbers(cell, seed: int, device) -> dict:
    import numpy as np

    from h100_bench.drivers.serve import PID_ADD, PID_MUL, reference_numbers
    from h100_bench.harness import check, inputs
    from h100_bench.harness import traffic as gen
    from h100_bench.reference.embed import Reference
    from h100_bench.reference.query import convqp_ids
    from h100_bench.reference.tokenizer import HashWordTokenizer

    import torch

    config, ix = cell.config, cell.config["index"]
    sess = gen.Sessions(cell.traffic, seed)
    cands = list(range(CANDIDATES))
    picked = check.sample(seed, cands, config["check"]["sample"], max(cands, key=sess.words_of))
    ctrl = Reference(config, inputs.make_params(config, seed, device), device, control=True)
    tok, L = HashWordTokenizer(config["vocab_size"]), config["max_concat_length"]
    ids = np.zeros((len(picked), L), np.int64)
    mask = np.zeros_like(ids)
    for m, j in enumerate(picked):
        row, n = convqp_ids(tok, *sess.request(j), max_concat=L)
        ids[m], mask[m, :n] = row, 1
    q = ctrl.embed(torch.from_numpy(ids), torch.from_numpy(mask))
    s, i = ctrl.index(inputs.make_rows(ix["rows"], ix["dim"], seed, device)).topk(q, ix["top_k"])
    del ctrl
    answers = [(ir * PID_MUL + PID_ADD, sr)
               for ir, sr in zip(i.cpu().numpy().astype(np.int64), s.double().cpu().numpy())]
    return reference_numbers(config, sess, seed, device, picked, answers)


def encode_numbers(cell, seed: int, device) -> dict:
    import numpy as np
    import torch

    from h100_bench.drivers.encode import row_err
    from h100_bench.harness import check, inputs
    from h100_bench.harness import traffic as gen
    from h100_bench.reference.embed import Reference
    from h100_bench.reference.search import index_codes

    config = cell.config
    corpus = gen.Corpus(cell.traffic, seed, config["vocab_size"])
    n = min(CANDIDATES, corpus.n)
    picked = check.sample(seed, list(range(n)), config["check"]["sample"],
                          int(np.argmax(corpus.lengths[:n])))
    ctrl = Reference(config, inputs.make_params(config, seed, device), device, control=True)
    ids = torch.from_numpy(corpus.ids_of(picked).astype(np.int64))
    mask = torch.from_numpy((np.arange(ids.shape[1])[None, :]
                             < corpus.lengths[picked][:, None]).astype(np.int64))
    rows = ctrl.embed(ids, mask)
    codes, scale = index_codes(rows, ctrl.levels)
    got = (codes.to(torch.float32) * scale).cpu().numpy()
    del ctrl
    return {"row_err": row_err(config, corpus, seed, device, picked, got)}


def judged(cell, seed: int, device):
    """(correct, {number: {value, limit}}) of the control's numbers."""
    from h100_bench.harness.check import judge

    fn = serve_numbers if cell.traffic["kind"] == "serve" else encode_numbers
    return judge(fn(cell, seed, device), cell.config["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    args = ap.parse_args(argv)

    import torch

    from h100_bench.harness.cell import load_cell

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        correct, checks = judged(cell, seed, device)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": correct,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
