"""Faults planted under a cell's timed path, to see its check come out
not correct at the cell's own size on the card:

    python3 h100_bench/faults.py --workload <cell> --seed <n> --seconds 5 \
        --faults stale,half,altered_row,altered_search

Each fault runs one whole run of the cell (set-up, window, check) with the
port patched underneath, and prints a line: the fault, ``correct`` and
each number compared beside its limit.  The CPU tests plant the same
faults at a tiny size (``tests/test_h100bench_run.py``).

* ``stale``: the tower returns its previous output of the same shape (a
  step that returns its state unchanged);
* ``half``: the second half of each batch's embeddings replaced by the
  mean of the first half (half of the batch left out, the mean taken over
  the rest);
* ``altered_row``: the first embedding of each batch negated (an answer
  altered where it is produced);
* ``altered_search``: the first query's best passage swapped for its k-th
  (serving cells only).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def stale(forward):
    last = {}

    def f(self, ids, mask, *a, **kw):
        out = forward(self, ids, mask, *a, **kw)
        prev = last.get(tuple(out.shape))
        last[tuple(out.shape)] = out.clone()
        return out if prev is None else prev
    return f


def half(forward):
    def f(self, ids, mask, *a, **kw):
        out = forward(self, ids, mask, *a, **kw).clone()
        h = max(1, out.shape[0] // 2)
        out[h:] = out[:h].mean(0, keepdim=True)
        return out
    return f


def altered_row(forward):
    def f(self, ids, mask, *a, **kw):
        out = forward(self, ids, mask, *a, **kw).clone()
        out[0] = -out[0]
        return out
    return f


def altered_search(search):
    def f(self, queries, k):
        s, i = search(self, queries, k)
        i = i.copy()
        i[0, 0] = i[0, -1]
        return s, i
    return f


TOWER_FAULTS = {"stale": stale, "half": half, "altered_row": altered_row}
SEARCH_FAULTS = {"altered_search": altered_search}


@contextlib.contextmanager
def planted(name: str):
    """The port patched with fault ``name`` inside the block."""
    if name in TOWER_FAULTS:
        from haconvdr_torch.models.encoder import AnceEncoder as owner
        attr, wrap = "forward", TOWER_FAULTS[name]
    else:
        from haconvdr_torch.parallel.sharded_search import ShardedIndex as owner
        attr, wrap = "search", SEARCH_FAULTS[name]
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's check with faults planted")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", required=True, help="comma-separated fault names")
    args = ap.parse_args(argv)

    import torch

    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.runner import execute

    if not torch.cuda.is_available():
        print("faults.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for name in args.faults.split(","):
        with planted(name):
            line, correct = execute(cell, args.seed, args.seconds, False, device,
                                    time.perf_counter())
        torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "seed": args.seed, "fault": name,
                          "correct": correct, "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
