"""The v4 flagged-window rescore (row 5 of the port's queue 2) on one card,
against another checkout's rescore kernel.

    python3 probes/probe_torch_rescore.py [--other DIR] [--variants] [--qs 1,8,256]
        [--sws 256,128]

Run from the root of the checkout to measure.  Over a 2,500,000 x 768
index made on the card from the seed (n_valid = N - 1,000, as
chip_smoke.py phase 3), in float32, bfloat16 and int8 (the codes of
quantize_int8_torch, queries as their per-query int8 codes), with each
query's slots as phase 3 makes them (7 random windows and an empty slot),
at each Q of ``--qs`` and sw of ``--sws``, it prints, each line with the
card's name and power limit:

- with ``--other DIR``: DIR's rescore kernel (built with DIR's own
  ``_build.py``, called through its own C interface) and this checkout's, in device ms (calls queued behind a
  spin of the card, ``chip_smoke.device_ms``) in the order other, this,
  this, other, with the bound (the distinct windows read once, as
  chip_smoke.py reckons it) and ms / bound; the two outputs compared bit
  for bit;
- with ``--variants``: this checkout's kernel under the text edits of
  ``VARIANTS`` (rows a piece, bytes a stage, stages), each built into
  build/variants/<name>, timed in two turns beside this
  checkout's at Q 1, 8 and 256 (sw 256, every mode), outputs bit for bit.

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

from chip_smoke import HBM_BYTES_PER_S, card_line, device_ms  # noqa: E402
from haconvdr_torch.index.quantize import quantize_int8_torch, quantize_queries_int8  # noqa: E402
from haconvdr_torch.ops import _build  # noqa: E402
from haconvdr_torch.ops import topk_v4 as v4  # noqa: E402
from probe_torch_window import build_variant, other_build  # noqa: E402

N_ROWS, DIM, N_PAD, SLOTS = 2_500_000, 768, 1_000, 8
MODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
VARIANT_QS = (1, 8, 64, 256)


def edits(**kw):
    """Text edits of csrc/topk_v4.cu's constants: NAME=value."""
    return [("topk_v4.cu", re.compile(rf"constexpr int {k} = \d+;"), f"constexpr int {k} = {v};")
            for k, v in kw.items()]


def lit(old: str, new: str):
    """A text edit of csrc/topk_v4.cu: the one occurrence of ``old``."""
    return [("topk_v4.cu", re.compile(re.escape(old)), new)]


# the rescore kernel's ring (csrc/topk_v4.cu, namespace rescore)
VARIANTS = {
    "8-rows": edits(ROWS=8),
    "512x2": edits(CH=512),
    "256x3": edits(STAGES=3),
    "launch-bounds-128": lit("__launch_bounds__(32) rescore_stream",
                             "__launch_bounds__(128) rescore_stream"),
    "launch-bounds-32x16": lit("__launch_bounds__(32) rescore_stream",
                               "__launch_bounds__(32, 16) rescore_stream"),
    # diagnostics (wrong answers; timed only): an eighth of the fmaf, no
    # copies after the query's
    "diag-one-fma-in-8": lit("for (int d = 0; d < 8; ++d) acc = fmaf(w[d], x[d], acc);",
                             "acc = fmaf(w[0], x[0], acc);"),
    "diag-no-copies": lit("if (s < nch) fill_stage(s);", "if (false) fill_stage(s);")
    + lit("if (c + STAGES - 1 < nch) fill_stage(", "if (false) fill_stage("),
}


def other_rescore(lib, p, q, win, sw, n_valid):
    """DIR's rescore kernel through its own C interface (the parent's:
    q, p, Q, N, D, n_valid, sw, B, win_ids, out, mode, stream)."""
    Q, B = win.shape
    out = torch.empty((Q, B * sw), dtype=torch.float32, device=p.device)
    err = lib.hc_rescore_windows(q.data_ptr(), p.data_ptr(), Q, p.shape[0], p.shape[1], n_valid,
                                 sw, B, win.data_ptr(), out.data_ptr(), MODE[p.dtype],
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"other hc_rescore_windows: CUDA error {err}")
    return out


def bound_ms(p, q, win, sw) -> float:
    """The distinct windows read once, the queries, the slots and the
    output, over the memory rate (chip_smoke.py's row 5 bound)."""
    n_win = int(torch.unique(win[win >= 0]).numel())
    nbytes = (n_win * sw * p.shape[1] * p.element_size() + q.numel() * q.element_size()
              + win.numel() * 4 + win.numel() * sw * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--qs", default="1,8,256")
    ap.add_argument("--sws", default="256,128")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_rescore: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    p32 = torch.randn(N_ROWS, DIM, device=dev, generator=g)
    codes, scale = quantize_int8_torch(p32)
    index = {"float32": p32, "bfloat16": p32.to(torch.bfloat16), "int8": codes}
    n_valid = N_ROWS - N_PAD
    qs = [int(x) for x in args.qs.split(",")]
    sws = [int(x) for x in args.sws.split(",")]
    lib_other = other_build(Path(args.other).resolve()).library() if args.other else None
    ok = True
    for sw in sws:
        W = -(-N_ROWS // sw)
        for Q in qs:
            qf = torch.randn(Q, DIM, device=dev, generator=g)
            win = torch.randint(0, W, (Q, SLOTS), device=dev, generator=g, dtype=torch.int32)
            win[:, -1] = -1  # an empty slot
            for name, p in index.items():
                q = quantize_queries_int8(qf * scale)[0] if name == "int8" else qf.to(p.dtype)
                b = bound_ms(p, q, win, sw)
                mine = v4.rescore_windows(p, q, win, sw, n_valid)
                tag = f"rescore {name} Q {Q} sw {sw}"
                if lib_other is not None:
                    theirs = other_rescore(lib_other, p, q, win, sw, n_valid)
                    torch.cuda.synchronize()
                    same = same_bits(mine, theirs)
                    ok &= same
                    ms = [device_ms(fn) for fn in (
                        lambda: other_rescore(lib_other, p, q, win, sw, n_valid),
                        lambda: v4.rescore_windows(p, q, win, sw, n_valid),
                        lambda: v4.rescore_windows(p, q, win, sw, n_valid),
                        lambda: other_rescore(lib_other, p, q, win, sw, n_valid))]
                    print(f"{tag}: other {ms[0]:.5f} / {ms[3]:.5f} ms, this {ms[1]:.5f} / "
                          f"{ms[2]:.5f} ms device ({ms[0] / ms[1]:.2f}x, {ms[3] / ms[2]:.2f}x); "
                          f"bound {b:.5f} ms (bytes), this {ms[1] / b:.2f}x it; bit-identical "
                          f"to the other's {same} [{card}]", flush=True)
            del qf, win
    if args.variants:
        lib_this = _build._lib
        libs = {name: build_variant(name, ed) for name, ed in VARIANTS.items()}
        sw = 256
        W = -(-N_ROWS // sw)
        for Q in VARIANT_QS:
            qf = torch.randn(Q, DIM, device=dev, generator=g)
            win = torch.randint(0, W, (Q, SLOTS), device=dev, generator=g, dtype=torch.int32)
            win[:, -1] = -1
            for name, p in index.items():
                q = quantize_queries_int8(qf * scale)[0] if name == "int8" else qf.to(p.dtype)
                run = lambda: v4.rescore_windows(p, q, win, sw, n_valid)  # noqa: E731
                _build._lib = lib_this
                want = run()
                times = {}
                for turn in range(2):
                    for vname in ["this"] + list(libs):
                        _build._lib = lib_this if vname == "this" else libs[vname]
                        if turn == 0 and vname != "this" and not vname.startswith("diag-"):
                            same = same_bits(run(), want)
                            ok &= same
                            if not same:
                                times[vname + " differs"] = True
                        times.setdefault(vname, []).append(round(device_ms(run), 5))
                _build._lib = lib_this
                print(f"variants rescore {name} Q {Q} sw {sw} (bound {bound_ms(p, q, win, sw):.5f}"
                      f" ms): {times} [{card}]", flush=True)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
