"""The knee of an open-loop serving cell: the mix offered at several rates
in turn, after one set-up, on the card:

    python3 h100_bench/sweep.py --workload <cell> --seed <n> --seconds 10 --rates 400,800,1200

Each rate's window is set up as a run's is (``harness.port.settle`` just
before it).  A line a rate: requests/s answered inside the window, the
dispatches and requests a dispatch, the latency's median and 95th
percentile, the median of the last tenth of the window's
requests against the first tenth (a backlog that grows all through the
window reads well above 1) and how late the generator ran.  The knee is
the highest rate whose backlog does not grow; a cell's ``rate`` is set to
about 0.8 of it, once, as a number in its traffic file.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the knee of an open-loop cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from h100_bench.drivers import serve
    from h100_bench.harness import traffic as gen
    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.port import settle

    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    mix = dict(cell.traffic)
    sess = gen.Sessions(mix, args.seed)
    retriever, batcher = serve.build(cell.config, mix, args.seed, device)
    serve.warm(retriever, sess, mix["max_batch"])
    k = cell.config["index"]["top_k"]
    for rate in (float(r) for r in args.rates.split(",")):
        mix["rate"] = rate
        due = gen.arrivals(mix, args.seconds)
        requests = [sess.request(j) for j in range(len(due))]
        torch.cuda.synchronize(device)
        settle()
        win = serve.Window()
        before = batcher.stats()
        t0 = serve.open_loop(batcher, requests, due, k, args.seconds, win)
        after = batcher.stats()
        order = sorted(win.answer, key=lambda j: win.t_ref[j])
        lat = np.array([win.t_done[j] - win.t_ref[j] for j in order]) * 1e3
        tenth = max(1, len(lat) // 10)
        print(json.dumps({
            "workload": cell.name, "rate": rate, "sent": len(win.t_ref),
            "answered_in_window": sum(1 for j in order if win.t_done[j] <= t0 + args.seconds)
            / args.seconds,
            "failed": len(win.failed), "p50_ms": float(np.median(lat)),
            "p95_ms": float(np.percentile(lat, 95)),
            "last_over_first": float(np.median(lat[-tenth:]) / np.median(lat[:tenth])),
            "gen_late_p95_ms": float(np.percentile(win.late, 95)) * 1e3,
            "dispatches": after["dispatches"] - before["dispatches"],
            "batch_mean": (after["queries"] - before["queries"])
            / max(1, after["dispatches"] - before["dispatches"]),
        }), flush=True)
    batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
