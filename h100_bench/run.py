"""One run of a benchmark cell of the PyTorch and CUDA port:

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It loads the cell from BENCHMARK.json,
makes its inputs from the seed on the card, warms up, measures for
``--seconds`` (``--trace 1``: under torch.profiler, for the per-layer
metrics), holds a sample of the outputs against the plain reference, and
prints the numbers compared with their limits as the last lines of
standard error and one JSON line as the last line of standard output.
Without a CUDA card it exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every build cache at a fixed path inside the checkout (the port's own
# nvcc builds go to build/haconvdr_torch/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.runner import execute, forbidden_modules

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    line, correct = execute(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"h100_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
