"""The v3 fused top-k (row 2 of the port's queue 2) on one card, against
another checkout's v3 kernel.

    python3 probes/probe_torch_v3.py [--other DIR] [--variants [--only PREFIX,...]]
        [--ptxas] [--qs 1,8,64,256,512,640,896,1024] [--geometries]

Run from the root of the checkout to measure.  Over a 2,500,000 x 768
index made on the card from the seed (n_valid = N - 1,000, k 100, as
chip_smoke.py phase 3), in float32, bfloat16 and the int8 mode (the codes
of quantize_int8_torch, bfloat16-rounded folded queries), unseeded and
seeded (the top 100 of the queries against 100,000 other rows, as phase
3), it prints, each line with the card's name and power limit:

- with ``--ptxas``: registers and spill stores of every kernel of
  csrc/fused_topk.cu (ptxas -v);
- with ``--other DIR``: DIR's v3 kernel (built with DIR's own
  ``_build.py``, called through its own C interface with the grid its
  wrapper computed: ``split_geometry`` over DIR's query tile) and this
  checkout's at each Q of ``--qs``, in device
  ms (calls queued behind a spin of the card, ``chip_smoke.device_ms``) in
  the order other, this, this, other, with the bound at the fmaf chain's
  rate (2 Q n_valid D operations at 67 TFLOP/s) and the two answers
  (scores and ids) compared bit for bit;
- with ``--variants``: this checkout's kernel under the text edits of
  ``VARIANTS`` (each built into build/variants/<name>), timed in two turns
  beside this checkout's at Q 256 (float32 and bfloat16, unseeded and
  seeded), each answer but the ``diag-`` ones' compared with this
  checkout's bit for bit;
- with ``--geometries``: at each Q of ``--qs`` where the two wave caps
  of ``split_geometry`` give different grids (Q 513-640 and 769-896 at
  132 SMs), float32 unseeded and seeded on the grid of each cap (two
  waves, the unseeded default, and eight, the seeded default), in the
  order this seed's default, the other, the other, the default; answers
  bit for bit.

Any disagreement exits 1.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import PEAK, card_line, device_ms  # noqa: E402
from haconvdr_torch.index.quantize import quantize_int8_torch  # noqa: E402
from haconvdr_torch.ops import _build  # noqa: E402
from haconvdr_torch.ops import fused_topk as ft  # noqa: E402
from probe_torch_window import build_variant, other_build, ptxas_info  # noqa: E402

N_ROWS, DIM, N_PAD, TOP_K = 2_500_000, 768, 1_000, 100
N_EXTRA = 100_000


def lit(old: str, new: str, src: str = "topk_split.cuh"):
    """A text edit of csrc/<src> (the split body that rows 2 and 7 share,
    by default): the one occurrence of ``old``."""
    return [(src, re.compile(re.escape(old)), new.replace("\\", r"\\"))]


VARIANTS = {
    # 64-query tiles at every Q (the narrower tile every k fits)
    "qb64": lit("return Q > 64 && Split<MODE, 128, false>::smem(k) <= (size_t)SMEM_MAX ? 128 : 64;",
                "return 64;", "fused_topk.cu"),
    # the k-buffers in the block's own slice of cand in device memory (L2)
    "buf-l2": lit("uint64_t* buf = reinterpret_cast<uint64_t*>(smem + K::BUF_OFF);",
                  "uint64_t* buf = cand + ((size_t)split * Q + q0) * k;")
    + lit("static size_t smem(int k) { return (size_t)BUF_OFF + (WIDE ? 0 : 8 * (size_t)QB * k); }",
          "static size_t smem(int) { return (size_t)BUF_OFF; }"),
    # survivor lists of 16 keys a query (f32 at QB 128: k <= 100)
    "list16": [("topk_split.cuh", re.compile(r"constexpr int LIST_SHARED = \d+;"),
                "constexpr int LIST_SHARED = 16;")],
    # diagnostic (a wrong answer, timed only): no survivor ever (the product,
    # the filter and one barrier a tile)
    "diag-no-select": lit("const float th = tau[qj(j)];",
                          "const float th = fmaxf(tau[qj(j)], 1e30f);"),
    # block 0, thread 0 prints its cycles: in all, in pushes (with the barrier
    # after them), in its warp's offers, in offers with the barrier after
    # them; offers, and entries its warp offered (the answer unchanged)
    "diag-count": lit("#include <type_traits>\n", "#include <type_traits>\n#include <stdio.h>\n")
    + lit("  auto offer_lists = [&]() {\n",
          "  long long d_t0 = clock64(), d_off = 0, d_wait = 0, d_push = 0;\n"
          "  int d_n = 0, d_ent = 0;\n"
          "  auto offer_lists = [&]() {\n    const long long d_c0 = clock64();\n    ++d_n;\n")
    + lit("      if (c == 0) continue;\n", "      if (c == 0) continue;\n      d_ent += min(c, LIST);\n")
    + lit("  };\n\n  float acc[8][NB];", "    d_off += clock64() - d_c0;\n  };\n\n  float acc[8][NB];")
    + lit("      offer_lists();\n      __syncthreads();\n",
          "      const long long d_c1 = clock64();\n      offer_lists();\n      __syncthreads();\n"
          "      d_wait += clock64() - d_c1;\n")
    + lit("    for (;;) {\n", "    for (;;) {\n      const long long d_c2 = clock64();\n")
    + lit("      if (!__syncthreads_or(m != 0)) break;\n",
          "      const bool d_more = __syncthreads_or(m != 0);\n      d_push += clock64() - d_c2;\n"
          "      if (!d_more) break;\n")
    + lit("  const uint64_t empty = make_key(-INFINITY, -1);\n",
          "  if (blockIdx.x == 0 && tid == 0)\n"
          "    printf(\"diag-count block 0: cycles %lld, pushes %lld, warp 0 offers %lld, offers with "
          "wait %lld, offers %d, entries %d\\n\", clock64() - d_t0, d_push, d_off, d_wait, d_n, "
          "d_ent);\n  const uint64_t empty = make_key(-INFINITY, -1);\n"),
}


def other_topk(lib, q, p, n_valid, k, seed):
    """DIR's v3 kernel through its own C interface, with the grid its
    wrapper computes: ``split_geometry`` over DIR's own query tile
    (``hc_topk_split_qb``), at most two waves unseeded and eight seeded."""
    dev = p.device
    q = q.to(ft.query_dtype(p.dtype)).contiguous()
    Q, D = q.shape
    N = p.shape[0]
    rows = max(0, min(int(n_valid), N))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qb = lib.hc_topk_split_qb(Q, k, ft._DTYPE_CODE[p.dtype])
    waves = ft.MAX_WAVES_UNSEEDED if seed is None else ft.MAX_WAVES_SEEDED
    splits, per = ft.split_geometry(Q, rows, sms, qb, waves)
    thr = None if seed is None else ft.seed_threshold(seed, k)
    cand = torch.empty((splits, Q, k), dtype=torch.int64, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.hc_topk_split(q.data_ptr(), p.data_ptr(), Q, N, D, rows, k,
                            None if thr is None else thr.data_ptr(), per, splits,
                            cand.data_ptr(), ft._DTYPE_CODE[p.dtype], stream)
    if err:
        raise RuntimeError(f"other hc_topk_split: CUDA error {err}")
    err = lib.hc_topk_merge(cand.data_ptr(), splits, Q, k,
                            None if seed is None else seed.data_ptr(),
                            0 if seed is None else seed.shape[1], out_s.data_ptr(),
                            out_i.data_ptr(), stream)
    if err:
        raise RuntimeError(f"other hc_topk_merge: CUDA error {err}")
    return out_s, out_i


def same_bits(a, b) -> bool:
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def chain_bound_ms(Q: int) -> float:
    """2 Q n_valid D fmaf operations at the CUDA cores' f32 rate (every
    mode runs the f32 chain)."""
    return 2.0 * Q * (N_ROWS - N_PAD) * DIM / PEAK["f32"] * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--only", default="",
                    help="variants whose name starts with one of these (comma-separated)")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--qs", default="1,8,64,256,512,640,896,1024")
    ap.add_argument("--geometries", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_v3: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    lib_this = _build.library()
    if args.ptxas:
        print(ptxas_info(_build.CSRC, "fused_topk.cu"), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    p32 = torch.randn(N_ROWS, DIM, device=dev, generator=g)
    codes, scale = quantize_int8_torch(p32)
    index = {"float32": p32, "bfloat16": p32.to(torch.bfloat16), "int8": codes}
    extra = torch.randn(N_EXTRA, DIM, device=dev, generator=g)
    n_valid = N_ROWS - N_PAD
    ok = True

    def operands(Q):
        q = torch.randn(Q, DIM, device=dev, generator=g)
        seed = torch.topk(q @ extra.T, TOP_K, dim=1).values.contiguous()
        return {"float32": q, "bfloat16": q, "int8": q * scale}, seed

    if args.variants:
        chosen = {k: v for k, v in VARIANTS.items()
                  if any(k.startswith(p) for p in args.only.split(","))}
        libs = {name: build_variant(name, ed) for name, ed in chosen.items()}
        qs, seed = operands(256)
        for name in ("float32", "bfloat16"):
            for seeded in (False, True):
                init = seed if seeded else None
                run = lambda: ft.fused_topk_block(qs[name], index[name], n_valid, TOP_K,  # noqa
                                                  init_scores=init)
                _build._lib = lib_this
                want = run()
                times = {}
                for turn in range(2):
                    for vname in ["this"] + list(chosen):
                        _build._lib = lib_this if vname == "this" else libs[vname]
                        if turn == 0 and vname != "this" and not vname.startswith("diag-"):
                            same = same_bits(run(), want)
                            ok &= same
                            times.setdefault(vname + " bit-identical", []).append(same)
                        times.setdefault(vname, []).append(round(device_ms(run, 3), 4))
                _build._lib = lib_this
                print(f"variants v3 {name} Q 256{' seeded' if seeded else ''} (bound "
                      f"{chain_bound_ms(256):.4f} ms): {times} [{card}]", flush=True)
        del qs, seed

    if args.other:
        other = Path(args.other).resolve()
        lib_other = other_build(other).library()
        for Q in (int(x) for x in args.qs.split(",")):
            qs, seed = operands(Q)
            for name, p in index.items():
                for seeded in (False, True):
                    q, init = qs[name], (seed if seeded else None)
                    mine = ft.fused_topk_block(q, p, n_valid, TOP_K, init_scores=init)
                    theirs = other_topk(lib_other, q, p, n_valid, TOP_K, init)
                    torch.cuda.synchronize()
                    same = same_bits(mine, theirs)
                    ok &= same
                    reps = 10 if Q <= 64 else 3
                    ms = [device_ms(fn, reps) for fn in (
                        lambda: other_topk(lib_other, q, p, n_valid, TOP_K, init),
                        lambda: ft.fused_topk_block(q, p, n_valid, TOP_K, init_scores=init),
                        lambda: ft.fused_topk_block(q, p, n_valid, TOP_K, init_scores=init),
                        lambda: other_topk(lib_other, q, p, n_valid, TOP_K, init))]
                    b = chain_bound_ms(Q)
                    print(f"v3 {name}{' seeded' if seeded else ''} Q {Q}: other {ms[0]:.4f} / "
                          f"{ms[3]:.4f} ms, this {ms[1]:.4f} / {ms[2]:.4f} ms device "
                          f"({ms[0] / ms[1]:.2f}x, {ms[3] / ms[2]:.2f}x); bound at the chain's "
                          f"rate {b:.4f} ms, this {ms[1] / b:.2f}x it; scores and ids "
                          f"bit-identical to the other's {same} [{card}]", flush=True)
            del qs, seed
    if args.geometries:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        default = ft.split_geometry
        caps = {False: ft.MAX_WAVES_UNSEEDED, True: ft.MAX_WAVES_SEEDED}
        for Q in (int(x) for x in args.qs.split(",")):
            qb = lib_this.hc_topk_split_qb(Q, TOP_K, 0)
            geo = {w: default(Q, n_valid, sms, qb, w) for w in caps.values()}
            if geo[caps[False]] == geo[caps[True]]:
                continue
            qs, seed = operands(Q)
            for seeded in (False, True):
                q, init = qs["float32"], (seed if seeded else None)
                mine, other = caps[seeded], caps[not seeded]
                run = lambda: ft.fused_topk_block(q, p32, n_valid, TOP_K, init_scores=init)  # noqa
                outs, ms = [], []
                for w in (mine, other, other, mine):
                    ft.split_geometry = lambda Q_, r, s_, b, _w=None, w=w: default(Q_, r, s_, b, w)
                    outs.append(run())
                    ms.append(device_ms(run, 3))
                ft.split_geometry = default
                same = same_bits(outs[0], outs[1])
                ok &= same
                print(f"v3 float32{' seeded' if seeded else ''} Q {Q}: default (at most {mine} "
                      f"waves) {geo[mine][0]} splits {ms[0]:.4f} / {ms[3]:.4f} ms, at most {other} "
                      f"waves {geo[other][0]} splits {ms[1]:.4f} / {ms[2]:.4f} ms device; "
                      f"bit-identical {same} [{card}]", flush=True)
            del qs, seed
    _build._lib = lib_this
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
