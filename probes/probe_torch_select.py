"""The v4 select kernel (rows 4 and 6 of the port's queue 2) and the whole
v4 search, timed on one card from the checkout it is run in.

    python3 <repo>/probes/probe_torch_select.py [--seed 0] [--reps 20] [--splits]

Run on a CUDA card from the root of the checkout to measure: that
checkout's ``haconvdr_torch`` and ``chip_smoke.py`` are imported, so two
checkouts (for example an unpacked parent) can be compared in one call,
each run from its own root, in turns.  It uses only the select API both
the single-block and the split kernel offer (``select_topk_t``,
``select_topk``, ``select_plain``, ``warm_floor``, ``topk_block_v4``).

Over a 2,500,000 x 768 N(0, 1) float32 index made on the card from the
seed (n_valid = N - 1,000, sw 256) and its int8 codes, with Q = 256
N(0, 1) queries, it builds the panels the v4 search hands the select
kernel, from the window kernel's real output:

- ``cold``: the pool [W + 8 sw, Q] = [11,814, Q] (chip_smoke's cold panel);
- ``warm``: [13,794, Q], with warm_floor's floor (chip_smoke's warm panel);
- ``path-v1``: the window maxima v1T [9,766, Q], k 100, cold;
- ``path-flag``: where(flagT, v2T, -inf), k = the f32 budget (8).

For each panel at Q 256, 7 and 1 (the first Q columns) and both layouts
(``select_topk_t`` on [C, Q]; ``select_topk`` on the contiguous [Q, C]
with a random permutation as tie-break ids) it checks the kernel bit for
bit against ``select_plain`` and prints the kernel's and ``torch.topk``'s
device ms on the same view (``chip_smoke.device_ms``: calls queued behind
a spin of the card; back to back, a small select's host time exceeds its
kernels', so plain CUDA events, also printed, time the host), the bound
(bytes over 3.35 TB/s) and ms / torch.topk.  Then the whole ``topk_block_v4`` at Q 256 and Q 1,
float32 and int8: ms (CUDA events), and the select kernels' share of the
device time of a profiled window.  ``--splits`` also times the split
kernel at fixed split counts (device ms; this checkout only, where it
has one); ``--variants`` builds text-edited variants of this checkout's
``csrc/topk_v4.cu`` into ``build/variants/`` (512 or 256 entries a step,
one or two 8-warp blocks an SM, and a build with clock64 counters per
phase) and times each on the cold pool and on v1T at Q 1.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call, as ``chip_smoke.device_ms`` times it (kept
    here, since a parent's chip_smoke may lack it): ``reps`` calls queued
    behind a spin of the card, which then runs them back to back (a small
    select's host time exceeds its kernels'), timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host could not enqueue the calls ahead of the card")


# text edits of csrc/topk_v4.cu for --variants
CLK = [  # cycles per phase (block (0, 0), thread 0) into g_clk; [5] counts steps
    ("namespace select_v4 {\n", "namespace select_v4 {\n__device__ unsigned long long g_clk[8];\n"
     "#define CLK(i, t) if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) "
     "atomicAdd(&g_clk[i], (unsigned long long)(clock64() - (t)));\n"),
    ("    __syncthreads();  // every warp is done with the last tile; lo_s, thr_s set\n",
     "    long long t0 = clock64();\n"
     "    __syncthreads();  // every warp is done with the last tile; lo_s, thr_s set\n"),
    ("    __syncthreads();\n    if (c0 + SEL_ROWS < c_end) fetch(c0 + SEL_ROWS);\n",
     "    __syncthreads();\n    CLK(0, t0); long long t1 = clock64();\n"
     "    if (c0 + SEL_ROWS < c_end) fetch(c0 + SEL_ROWS);\n    CLK(1, t1); long long t2 = clock64();\n"),
    ("      __syncwarp();\n      for (int i = lane; i < taken; i += 32) {",
     "      __syncwarp();\n      CLK(2, t2);\n"
     "      if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) atomicAdd(&g_clk[5], 1ull);\n"
     "      for (int i = lane; i < taken; i += 32) {"),
    ("  const Cut c1 = radix_cut<N>(x, elig, (uint32_t)k, hist);\n",
     "  long long ta = clock64();\n  const Cut c1 = radix_cut<N>(x, elig, (uint32_t)k, hist);\n  CLK(3, ta);\n"),
    ("  if (q < Q) {  // one split: the answer, ranked; else this split's candidates\n",
     "  long long tw = clock64();\n"
     "  if (q < Q) {  // one split: the answer, ranked; else this split's candidates\n"),
    ("               out_s + o, out_i + o);\n  }\n}\n",
     "               out_s + o, out_i + o);\n  }\n  CLK(4, tw);\n}\n"),
]
VARIANTS = {
    "base": [],
    "rows256": [("constexpr int SEL_ROWS = 512; ", "constexpr int SEL_ROWS = 256; ")],
    "two-blocks-an-SM": [("__launch_bounds__(SEL_QT * 32) select_kernel(",
                          "__launch_bounds__(SEL_QT * 32, 2) select_kernel(")],
    "clk": CLK,
}


def build_variant(name: str, edits):
    """This checkout's csrc with topk_v4.cu text-edited, built into
    build/variants/select-<name> with the port's nvcc flags and loaded."""
    import ctypes
    import shutil
    from pathlib import Path

    from haconvdr_torch.ops import _build

    root = Path("build/variants") / f"select-{name}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root / "csrc")
    src = root / "csrc" / "topk_v4.cu"
    text = src.read_text()
    for a, b in edits:
        if a not in text:
            raise RuntimeError(f"variant {name}: anchor not found: {a[:60]!r}")
        text = text.replace(a, b)
    if name == "clk":
        text += ('\nextern "C" int hc_sel_clk(void* dst, int reset) {\n'
                 '  static unsigned long long zero[8];\n'
                 '  return reset ? (int)cudaMemcpyToSymbol(select_v4::g_clk, zero, sizeof(zero))\n'
                 '               : (int)cudaMemcpyFromSymbol(dst, select_v4::g_clk, sizeof(zero));\n}\n')
    src.write_text(text)
    so = root / "lib.so"
    _build._compile_and_link(_build._nvcc(), sorted((root / "csrc").glob("*.cu")), root, so)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hc_error_string.argtypes = [ctypes.c_int]
    lib.hc_error_string.restype = ctypes.c_char_p
    return lib


def run_variants(v4, panels, card: str, reps: int) -> None:
    """Each variant on the cold pool (Q 256, both layouts) and on v1T at
    Q 1, bit for bit against select_plain; the clk variant's cycles per
    step and phase, one warp walking the whole cold pool at Q 1."""
    import ctypes

    from haconvdr_torch.ops import _build

    libs = {name: build_variant(name, edits) for name, edits in VARIANTS.items()}
    cold, v1 = panels["cold"][0], panels["path-v1"][0]
    cases = (("cold [C, Q] Q 256", cold.T, None), ("cold [Q, C] Q 256", cold.T.contiguous(), None),
             ("path-v1 Q 1", v1[:, :1].T, None))
    for name, lib in libs.items():
        _build._lib = lib
        parts = []
        for what, view, ids in cases:
            got, ref = v4._select(view, 100, None, ids, "select"), v4.select_plain(view, 100)
            torch.cuda.synchronize()
            same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            ms = device_ms(lambda: v4._select(view, 100, None, ids, "select"), reps)
            parts.append(f"{what} {ms:.4f} ms{'' if same else ' DIFFERS'}")
        print(f"variant {name}: " + ", ".join(parts) + f" [{card}]")
        if name == "clk":
            buf = (ctypes.c_ulonglong * 8)()
            lib.hc_sel_clk(buf, 1)
            v4._select(cold[:, :1].T, 100, None, None, "select", splits=1)
            torch.cuda.synchronize()
            lib.hc_sel_clk(buf, 0)
            n = max(1, buf[5])
            print(f"variant clk, cold Q 1 in one warp ({n} steps of SEL_ROWS): cycles a step: "
                  f"staging {buf[0] // n}, next tile's loads {buf[1] // n}, selection "
                  f"{buf[2] // n} (of which the score radix {buf[3] // n}); the final "
                  f"ranking {buf[4]} [{card}]")


def select_share(run, n: int = 5):
    """(select kernels' device ms, all device ms) per call over n calls."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    sel = tot = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if e.device_type.name != "CUDA" or not t:
            continue
        tot += t
        if "select_kernel" in e.key:
            sel += t
    return sel / n / 1e3, tot / n / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time text-edited variants of this checkout's select")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_select: no CUDA card", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from haconvdr_torch.index.quantize import quantize_int8_torch
    from haconvdr_torch.ops import topk_v4 as v4

    card = cs.card_line()
    where = os.getcwd()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    N, D, k = cs.N_ROWS, cs.DIM, cs.TOP_K
    n_valid = N - cs.N_PAD
    passages = torch.randn(N, D, device=dev, generator=g)
    queries = torch.randn(cs.Q_KERNEL, D, device=dev, generator=g)
    sw, budget = v4.resolve_select_geometry(N, torch.float32)
    v1, _, v2 = v4.window_top2(queries, passages, n_valid, sw)
    W = v1.shape[0]
    v_k = v4.select_plain(v1.T, k)[0][:, k - 1]
    flag = (v2 >= v_k[None, :]) & torch.isfinite(v2)
    panels = {
        "cold": (torch.cat([v1, v2[: 8 * sw]]).contiguous(), k, False),
        "warm": (torch.cat([v1, v2[: cs.WARM_POOL - W]]).contiguous(), k, True),
        "path-v1": (v1.contiguous(), k, False),
        "path-flag": (torch.where(flag, v2, float("-inf")).contiguous(), budget, False),
    }
    for name, (panel, kk, warm) in panels.items():
        for Q in (256, 7, 1):
            p = panel[:, :Q].contiguous()
            fl = v4.warm_floor(p, kk) if warm else None
            ids = torch.randperm(p.shape[0], device=dev, generator=g).to(torch.int32)
            rows = p.T.contiguous()  # [Q, C]; at Q = 1 the view of p itself
            rows_ids = torch.empty_like(rows, dtype=torch.int32).copy_(ids[None, :].expand(Q, -1))
            cases = (
                ("select_topk_t", lambda: v4.select_topk_t(p, kk, floor=fl),
                 lambda: v4.select_plain(p.T, kk, fl), lambda: torch.topk(p, kk, dim=0), 0),
                ("select_topk", lambda: v4.select_topk(rows, kk, floor=fl, ids=rows_ids),
                 lambda: v4.select_plain(rows, kk, fl, rows_ids),
                 lambda: torch.topk(rows, kk, dim=1), rows_ids.numel() * 4),
            )
            for kname, run, plain, lib, id_bytes in cases:
                got, ref = run(), plain()
                torch.cuda.synchronize()
                same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                ms, lib_ms = device_ms(run, args.reps), device_ms(lib, args.reps)
                ev_ms, ev_lib = cuda_ms(run, args.reps), cuda_ms(lib, args.reps)
                bound = (p.numel() * 4 + id_bytes + Q * kk * 8) / HBM_BYTES_PER_S * 1e3
                print(f"select {kname} [{name}] [{p.shape[0]}, {Q}] k {kk}: {ms:.4f} ms device "
                      f"(events {ev_ms:.4f}), torch.topk {lib_ms:.4f} ms device (events "
                      f"{ev_lib:.4f}), bound {bound:.5f} ms (bytes), ms / torch.topk "
                      f"{ms / lib_ms:.2f}, equal to select_plain {same} [{card}] [{where}]")
                if args.splits and hasattr(v4, "select_splits"):
                    for s in (1, 2, 3, 4, 6, 8, 12, 16, 24):
                        t = device_ms(lambda: v4._select(
                            p.T if kname == "select_topk_t" else rows, kk, fl,
                            None if kname == "select_topk_t" else rows_ids, "select",
                            splits=s), args.reps)
                        print(f"  splits {s}: {t:.4f} ms [{card}]")
    if args.variants:
        run_variants(v4, panels, card, args.reps)
    del v1, v2, flag, panels
    codes, scale = quantize_int8_torch(passages)
    for name, p in (("float32", passages), ("int8", codes)):
        for Q in (256, 1):
            q = queries[:Q] * (scale if name == "int8" else 1.0)
            run = lambda: v4.topk_block_v4(q, p, n_valid, k)  # noqa: E731
            ms = cuda_ms(run, max(3, args.reps // 4))
            sel, tot = select_share(run)
            print(f"topk_block_v4 {name} Q {Q}: {ms:.3f} ms, select kernels {sel:.4f} ms of "
                  f"{tot:.3f} device ms ({100 * sel / max(tot, 1e-9):.1f}%) [{card}] [{where}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
