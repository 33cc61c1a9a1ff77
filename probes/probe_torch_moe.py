"""The expert layer (``ops/moe.py``, csrc/moe_experts.cu) timed on one card
at DeepSeek-V2-Lite's widths, from the checkout it is run in:

    python3 <repo>/probes/probe_torch_moe.py [--seed 0] [--tokens 2048,21000] [--reps 10]

For each token count T (top 6 of 64 experts, H 2048, I 1408, random bf16
weights and tokens from the seed) it prints one JSON line: the card's name
and power limit; the device ms of one ``routed_experts`` call by kernel
(the routing kernel, the grouped up- and down-projections) and in all, from
torch.profiler over ``--reps`` calls; the bound (the larger of 2 x T x 6 x 3
x H x I operations at 989 TFLOP/s and the experts' weights, 1.1 GB, at
3.35 TB/s) and the kernels' share of it; the plain twin's ms (CUDA events,
one call); ``torch._grouped_mm``'s ms for the same two grouped products
over tokens already sorted by expert (the library yardstick; none where
this PyTorch lacks it); the largest relative row error against the twin;
and the expert loads' largest over mean (the routing skew of these random
weights).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H, I, E, K = 2048, 1408, 64, 6


def card():
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else torch.cuda.get_device_name()


def events_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", default="2048,21000")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from haconvdr_torch.ops import moe

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    gate = (torch.randn(E, H, device=dev, generator=g) * 0.05).to(torch.bfloat16)
    w13 = (torch.randn(E, 2 * I, H, device=dev, generator=g) * 0.05).to(torch.bfloat16)
    w2 = (torch.randn(E, H, I, device=dev, generator=g) * 0.05).to(torch.bfloat16)
    name = card()
    for T in (int(t) for t in args.tokens.split(",")):
        x = torch.randn(T, H, device=dev, generator=g).to(torch.bfloat16)

        def call():
            return moe.routed_experts(x, gate, w13, w2, K)

        out = call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        by = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if t:
                by[ev.key[:60]] = round(t / 1e3 / args.reps, 4)
        moe_ms = sum(v for k, v in by.items() if "moe_" in k)
        ops = 2.0 * T * K * 3 * H * I
        nbytes = E * 3 * H * I * 2
        bound = max(ops / 989e12, nbytes / 3.35e12) * 1e3
        plain_ms = events_ms(lambda: moe.routed_experts_plain(x, gate, w13, w2, K), 1)
        ref = moe.routed_experts_plain(x, gate, w13, w2, K)
        err = float(((out.float() - ref.float()).norm(dim=-1)
                     / ref.float().norm(dim=-1)).max())
        lib_ms = None
        if hasattr(torch, "_grouped_mm"):
            w, e = moe.route_plain(x, gate, K)
            order = torch.argsort(e.flatten())
            xs = x[order // K]
            offs = torch.cumsum(torch.bincount(e.flatten(), minlength=E), 0).to(torch.int32)

            def lib():
                gu = torch._grouped_mm(xs, w13.transpose(1, 2), offs=offs)
                gt, up = gu.chunk(2, dim=-1)
                return torch._grouped_mm(F.silu(gt) * up, w2.transpose(1, 2), offs=offs)

            try:
                lib_ms = events_ms(lib, args.reps)
            except RuntimeError as exc:  # shapes or build this PyTorch refuses
                lib_ms = f"refused: {str(exc)[:120]}"
        loads = torch.bincount(moe.route_plain(x, gate, K)[1].flatten(), minlength=E).float()
        print(json.dumps({
            "card": name, "T": T, "kernels_ms": by, "moe_kernels_ms": round(moe_ms, 4),
            "call_ms_events": round(events_ms(call, args.reps), 4), "bound_ms": round(bound, 4),
            "roofline_pct": round(100 * bound / moe_ms, 2) if moe_ms else None,
            "plain_ms": round(plain_ms, 3), "grouped_mm_ms": lib_ms, "max_row_err": err,
            "skew": round(float(loads.max() / loads.mean()), 3)}), flush=True)


if __name__ == "__main__":
    main()
