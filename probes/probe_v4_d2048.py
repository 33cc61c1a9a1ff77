"""Where the v4 search at D 2048 in bfloat16 departs from the exact top-k,
on one card:

    python3 probes/probe_v4_d2048.py [--rows 1000000] [--seed 0]

Makes the rows and 64 queries as tests/test_torch_cuda.py's
``test_v4_search_bf16_at_d2048_over_a_million_rows`` does, then prints one
JSON line a search (``ShardedIndex.search``, ``topk_block_v4`` on the rows
directly, the v3 kernel ``fused_topk_block``, and ``topk_block_v4`` over
the first half of the rows): the largest |score - exact| / |exact| against
the float32 exact top-k (TF32 off), the largest |score - its own id's
float64 score| / |exact| (a score that is not its row's), the exact top-k
rows missing from the answer at separated ranks, and the v4 counters.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def exact_topk(q, rows, k, step=100_000):
    import torch

    best_s = best_i = None
    for a in range(0, rows.shape[0], step):
        sc = q @ rows[a:a + step].float().T
        ts, ti = torch.topk(sc, k, dim=1)
        ti = ti + a
        if best_s is not None:
            ts, j = torch.topk(torch.cat([best_s, ts], 1), k, dim=1)
            ti = torch.gather(torch.cat([best_i, ti], 1), 1, j)
        best_s, best_i = ts, ti
    return best_s, best_i


def compare(name, s, i, rs, ri, q64, rows, counts):
    import torch

    s = torch.as_tensor(s).double().cpu()
    i = torch.as_tensor(i).long().cpu()
    rs, ri = rs.double().cpu(), ri.long().cpu()
    scale = rs.abs()
    own = torch.stack([(rows[i[b].clamp_min(0).to(rows.device)].double()
                        @ q64[b]).cpu() for b in range(i.shape[0])])
    gap = torch.minimum(torch.cat([torch.full_like(rs[:, :1], float("inf")),
                                   (rs[:, 1:] - rs[:, :-1]).abs()], 1),
                        torch.cat([(rs[:, 1:] - rs[:, :-1]).abs(),
                                   torch.full_like(rs[:, :1], float("inf"))], 1))
    clear = gap > 2e-4 * scale
    missing = sum(len(set(ri[b][clear[b]].tolist()) - set(i[b].tolist()))
                  for b in range(i.shape[0]))
    rel = (s - rs).abs() / scale
    bad_q = sorted({int(b) for b in (rel > 1e-4).nonzero()[:, 0].tolist()})
    print(json.dumps({
        "search": name, "max_rel_err": float(rel.max()),
        "positions_past_1e-4": int((rel > 1e-4).sum()), "queries_past_1e-4": bad_q[:16],
        "max_own_score_err": float(((s - own).abs() / scale).max()),
        "ids_differ_at_clear": int((i != ri)[clear].sum()), "clear_share": float(clear.double().mean()),
        "exact_rows_missing": missing, "counts": counts}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    from haconvdr_torch.ops import fused_topk, topk_v4
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    N, D, k = args.rows, 2048, 100
    rows = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    for a in range(0, N, 100_000):
        rows[a:a + 100_000] = torch.randn(min(100_000, N - a), D, device=dev, generator=gen)
    q = torch.randn(64, D, device=dev, generator=gen)
    qb = q.to(torch.bfloat16)
    q64 = qb.double()
    rs, ri = exact_topk(qb.float(), rows, k)

    def counted(fn):
        for key in topk_v4.COUNTS:
            topk_v4.COUNTS[key] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, dict(topk_v4.COUNTS)

    (s, i), c = counted(lambda: ShardedIndex.from_tensor(rows, dtype="bfloat16")
                        .search(q.cpu().numpy(), k))
    compare("ShardedIndex.search", s, i, rs, ri, q64, rows, c)
    (s, i), c = counted(lambda: topk_v4.topk_block_v4(qb, rows, N, k))
    compare("topk_block_v4", s, i, rs, ri, q64, rows, c)
    (s, i), c = counted(lambda: fused_topk.fused_topk_block(qb, rows, N, k))
    compare("fused_topk_block (v3)", s, i, rs, ri, q64, rows, c)
    half = N // 2
    hs, hi = exact_topk(qb.float(), rows[:half], k)
    (s, i), c = counted(lambda: topk_v4.topk_block_v4(qb, rows[:half].contiguous(), half, k))
    compare(f"topk_block_v4 over the first {half} rows", s, i, hs, hi, q64, rows, c)


if __name__ == "__main__":
    main()
