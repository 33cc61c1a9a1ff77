"""The int8 tower's kernels (rows 8-10 of the port's queue 2) against
another checkout's, on one card, in one process.

    python3 probes/probe_torch_int8_tower.py --other DIR [--ln-variants]

Run from the root of the checkout to measure.  It builds that checkout's
kernel library (``haconvdr_torch.ops._build``) and the library of the
checkout at DIR (for example the parent, unpacked with ``git archive``
under ``scratch/``) with DIR's own ``_build.py``, and swaps them in as
``_build``'s library in turns.  Rows 8-9 run through this checkout's
wrappers (their C interface is the same in both); DIR's row 10 is called
through its own C interface.  It prints, each line with the card's name
and power limit:

- registers and spill stores of every kernel of csrc/fused_ln.cu and
  csrc/fused_mlp.cu in both checkouts (ptxas -v);
- row 8 (+ residual, no residual) and row 9 (bf16 + residual, f32 in
  without residual) at [98,304, 768]: the device ms of a call in the order
  other, this, this, other (calls queued behind a spin of the card,
  ``chip_smoke.device_ms``), ``F.layer_norm``'s beside the no-residual
  case, and the share of y (and of the codes) that differs between the
  two checkouts;
- row 10 at 512, 24,576 and 98,304 rows (H 768, I 3072) the same way, and
  this checkout's output against the plain twin in the JAX package's
  bounds;
- with ``--ln-variants``: DIR's fused_ln.cu under text edits that bound
  what limits it (weights as constants; four or sixteen rows a block) and
  a bf16 copy of the same bytes (``Tensor.copy_``), timed in turns;
- with ``--variants``: this checkout's csrc under the text edits of
  ``VARIANTS``, each built into ``build/variants/<name>``: row 10 at
  24,576 and 98,304 rows, row 8 without residual and row 9 from f32, timed
  in turns, and row 10's device time by kernel (torch.profiler) at
  98,304 rows.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())

from chip_smoke import card_line, device_ms, int8_weight  # noqa: E402
from haconvdr_torch.index.quantize import quantize_rows  # noqa: E402
from haconvdr_torch.ops import _build  # noqa: E402
from haconvdr_torch.ops import fused_ln as fl  # noqa: E402
from haconvdr_torch.ops import fused_mlp as fm  # noqa: E402

H, I, ROWS = 768, 3072, 256 * 384
MLP_ROWS = (512, 24_576, ROWS)
EPS = 1e-5
REPS = 20


# name -> [(file, old, new)]: text edits of this checkout's csrc
LDS = [
    ("fused_mlp.cu", "bf[j] = *reinterpret_cast<const int4*>(b + j * 8 * BK + off);",
     "bf[j] = make_int4(kt, j, tig, off);"),
    ("fused_mlp.cu", "const int4 lo = *reinterpret_cast<const int4*>(a + i * 16 * BK + off);",
     "const int4 lo = make_int4(kt, i, off, g);"),
    ("fused_mlp.cu", "const int4 hi = *reinterpret_cast<const int4*>(a + (i * 16 + 8) * BK + off);",
     "const int4 hi = make_int4(i, kt, g, off);")]
MMA = [
    ("fused_mlp.cu", "mma_s8(acc[i][j], lo.x, hi.x, lo.y, hi.y, bf[j].x, bf[j].y);",
     "acc[i][j][0] ^= lo.x ^ hi.x ^ lo.y ^ hi.y ^ bf[j].x ^ bf[j].y;"),
    ("fused_mlp.cu", "mma_s8(acc[i][j], lo.z, hi.z, lo.w, hi.w, bf[j].z, bf[j].w);",
     "acc[i][j][1] ^= lo.z ^ hi.z ^ lo.w ^ hi.w ^ bf[j].z ^ bf[j].w;")]
REFILL = [("fused_mlp.cu", "if (kt + STAGES - 1 < KT)\n      load_stage(",
           "if (false)\n      load_stage(")]
CONSTS = "BM = 128, BN = 128, BK = 128, WM = 64, WN = 32, NT = 256, STAGES = 3, MINB = 2;"


def consts(**kw):
    """The product kernels' constants line of csrc/fused_mlp.cu, edited."""
    d = dict(BM=128, BN=128, BK=128, WM=64, WN=32, NT=256, STAGES=3, MINB=2)
    d.update(kw)
    return [("fused_mlp.cu", CONSTS, "BM = {BM}, BN = {BN}, BK = {BK}, WM = {WM}, WN = {WN}, "
             "NT = {NT}, STAGES = {STAGES}, MINB = {MINB};".format(**d))]


# The product kernels under text edits.  The first four take one part of the
# main loop away (wrong answers; timed only): the copies from L2 after the
# first stages (no-refill), the shared-memory fragment loads (no-lds), both
# (mma-only), or the products and the loads (refill-only).  The others
# change the tile: 64-byte chunks four stages deep, and 64 x 64 warp tiles
# (one block an SM).  And the LayerNorm of the weights read from global
# memory instead of shared memory.
VARIANTS = {
    "no-refill": REFILL,
    "no-lds": LDS,
    "mma-only": LDS + REFILL,
    "refill-only": LDS + MMA,
    "bk64-4-stages": consts(BK=64, STAGES=4),
    "t128x256-w64x64": consts(BN=256, WN=64, MINB=1),
    "ln-weights-global": [("fused_ln.cu", "(v, w_s[0], w_s[1], eps,", "(v, scale, bias, eps,")],
}


def other_build(root: Path):
    """DIR's own haconvdr_torch/ops/_build.py, loaded as a separate module."""
    spec = importlib.util.spec_from_file_location(
        "other_build", root / "haconvdr_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(so: Path, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hc_error_string.argtypes = [ctypes.c_int]
    lib.hc_error_string.restype = ctypes.c_char_p
    return lib


def build_variant(name: str, csrc: Path, edits, signatures) -> ctypes.CDLL:
    """csrc copied to build/variants/<name>/csrc with text edits
    [(file, old, new)], built with the port's nvcc flags and loaded."""
    root = Path("build/variants") / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(csrc, root / "csrc")
    for fname, old, new in edits:
        p = root / "csrc" / fname
        text = p.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {fname}")
        p.write_text(text.replace(old, new))
    so = root / "lib.so"
    _build._compile_and_link(_build._nvcc(), sorted((root / "csrc").glob("*.cu")), root, so)
    return load(so, signatures)


def ptxas_info(csrc: Path, tag: str, sources=("fused_ln.cu", "fused_mlp.cu")) -> str:
    lines = []
    out_dir = Path("build/variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in sources:
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-c", "-o",
             str(out_dir / "ptxas.o"), str(csrc / src)], capture_output=True, text=True)
        info = res.stdout + res.stderr
        for block in re.split(r"ptxas info\s+: Compiling entry function", info)[1:]:
            name = block.split("'")[1] if "'" in block else block[:80]
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            lines.append(f"ptxas [{tag}] {src} {name}: {regs.group(1) if regs else '?'} "
                         f"registers, {spill.group(1) if spill else '?'} bytes spill stores")
    return "\n".join(lines)


def ab(fn_other, fn_this, lib_other, lib_this):
    """Device ms of a call: other, this, this, other."""
    out = []
    for lib, fn in ((lib_other, fn_other), (lib_this, fn_this), (lib_this, fn_this),
                    (lib_other, fn_other)):
        _build._lib = lib
        out.append(device_ms(fn, REPS))
    _build._lib = lib_this
    return out


def share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a != b).float().mean())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="root of the checkout to compare with")
    ap.add_argument("--ln-variants", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_int8_tower: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    other = Path(args.other).resolve()
    ob = other_build(other)
    lib_this = _build.library()
    lib_other = ob.library()
    print(ptxas_info(_build.CSRC, "this"))
    print(ptxas_info(other / "haconvdr_torch" / "csrc", "other"))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x32 = torch.randn(ROWS, H, device=dev, generator=g) * 3.0
    xb = x32.to(torch.bfloat16)
    r = torch.randn(ROWS, H, device=dev, generator=g).to(torch.bfloat16)
    lns = torch.randn(H, device=dev, generator=g) * 0.5 + 1.0
    lnb = torch.randn(H, device=dev, generator=g) * 0.1
    bf = torch.bfloat16
    cases = (
        ("row 8 bf16 + residual", lambda: fl.fused_residual_ln(xb, r, lns, lnb, EPS)),
        ("row 8 bf16, no residual", lambda: fl.fused_residual_ln(xb, None, lns, lnb, EPS)),
        ("row 9 bf16 + residual", lambda: fl.fused_residual_ln_quant(xb, r, lns, lnb, EPS)),
        ("row 9 f32 in, no residual",
         lambda: fl.fused_residual_ln_quant(x32, None, lns, lnb, EPS, bf)),
    )
    for name, run in cases:
        _build._lib = lib_other
        want = run()
        _build._lib = lib_this
        got = run()
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            diff = (f"y differs at {share(got[0], want[0]):.3e}, yq at "
                    f"{share(got[1], want[1]):.3e}, ys at {share(got[2], want[2]):.3e}")
        else:
            diff = f"y differs at {share(got, want):.3e}"
        ms = ab(run, run, lib_other, lib_this)
        line = (f"{name} [{ROWS}, {H}]: other {ms[0]:.4f} / {ms[3]:.4f} ms, this "
                f"{ms[1]:.4f} / {ms[2]:.4f} ms device; {diff}")
        if name == "row 8 bf16, no residual":
            lw, lb = lns.to(bf), lnb.to(bf)
            lib_ms = device_ms(lambda: F.layer_norm(xb, (H,), lw, lb, EPS), REPS)
            line += f"; F.layer_norm {lib_ms:.4f} ms"
        print(f"{line} [{card}]", flush=True)
    del x32, want, got

    # -- row 10
    mlp_runs = {}
    w1, s1 = int8_weight(g, dev, I, H)
    w2, s2 = int8_weight(g, dev, H, I)
    b1 = torch.randn(I, device=dev, generator=g) * 0.02
    b2 = torch.randn(H, device=dev, generator=g) * 0.02
    for rows in MLP_ROWS:
        x = fl.fused_residual_ln_plain(xb[:rows], r[:rows], lns, lnb, EPS)
        xq, xs = quantize_rows(x)
        xs = xs.contiguous()
        margs = (x, xq, xs, w1, s1, b1, w2, s2, b2, lns, lnb)

        def this_mlp(margs=margs):
            return fm.fused_mlp_block(*margs, eps=EPS)

        def other_mlp(x=x, xq=xq, xs=xs, rows=rows):
            y = torch.empty_like(x)
            yq = torch.empty_like(xq)
            ys = torch.empty((rows, 1), dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            err = lib_other.hc_fused_mlp(
                x.data_ptr(), xq.data_ptr(), xs.data_ptr(), w1.data_ptr(), s1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), lns.data_ptr(),
                lnb.data_ptr(), EPS, rows, H, I, y.data_ptr(), yq.data_ptr(), ys.data_ptr(),
                stream)
            if err:
                raise RuntimeError(f"other hc_fused_mlp: CUDA error {err}")
            return y, yq, ys

        mlp_runs[rows] = this_mlp
        (y, yq, ys), (oy, oq, os_) = this_mlp(), other_mlp()
        ry, _, _ = fm.fused_mlp_block_plain(*margs, eps=EPS)
        torch.cuda.synchronize()
        d = (y.float() - ry.float()).abs()
        flips = float((d > 2.0**-6 * (1 + ry.float().abs())).float().mean())
        qy, qs = quantize_rows(y)
        ok = (bool((d <= 2.0**-6 * ry.float().abs() + 0.07).all()) and flips < 2e-3
              and torch.equal(yq, qy) and torch.equal(ys, qs))
        ms = ab(other_mlp, this_mlp, lib_other, lib_this)
        print(f"row 10 [{rows}, {H}, {I}]: other {ms[0]:.4f} / {ms[3]:.4f} ms, this "
              f"{ms[1]:.4f} / {ms[2]:.4f} ms device ({ms[0] / ms[1]:.2f}x, "
              f"{ms[3] / ms[2]:.2f}x); y differs from the other's at {share(y, oy):.3e}, "
              f"yq at {share(yq, oq):.3e}; against the twin max {float(d.max()):.4f}, "
              f"flips {flips:.2e}, JAX bounds and codes {'hold' if ok else 'FAIL'} [{card}]",
              flush=True)
        if not ok:
            return 1
        del x, xq, xs, y, yq, ys, oy, oq, os_, ry, d

    if args.ln_variants:
        csrc = other / "haconvdr_torch" / "csrc"
        variants = {
            "other": lib_other,
            "weights-const": build_variant(
                "weights_const", csrc,
                [("ln_quant.cuh", "scale[c]), bias[c])", "1.0f), 0.0f)")], ob.SIGNATURES),
            "4-rows-a-block": build_variant(
                "rows4", csrc, [("fused_ln.cu", "ROWS_PER_BLOCK = 8;", "ROWS_PER_BLOCK = 4;")],
                ob.SIGNATURES),
            "16-rows-a-block": build_variant(
                "rows16", csrc, [("fused_ln.cu", "ROWS_PER_BLOCK = 8;", "ROWS_PER_BLOCK = 16;")],
                ob.SIGNATURES),
        }
        out = torch.empty_like(xb)
        for turn in range(2):
            for vname, lib in variants.items():
                for name, run in cases[:2]:
                    _build._lib = lib
                    print(f"ln variant {vname} {name}: {device_ms(run, REPS):.4f} ms "
                          f"(turn {turn}) [{card}]")
            print(f"bf16 copy of [{ROWS}, {H}] (Tensor.copy_): "
                  f"{device_ms(lambda: out.copy_(xb), REPS):.4f} ms (turn {turn}) [{card}]")
        _build._lib = lib_this
    if args.variants:
        from chip_smoke import profile_window

        libs = {"this": lib_this}
        for name, edits in VARIANTS.items():
            libs[name] = build_variant(name, _build.CSRC, edits, _build.SIGNATURES)
            print(ptxas_info(Path("build/variants") / name / "csrc", name,
                             sorted({f for f, _, _ in edits})))
        x32 = torch.randn(ROWS, H, device=dev, generator=g) * 3.0
        timed = {
            "row 10 [512]": mlp_runs[512], "row 10 [24576]": mlp_runs[24_576],
            f"row 10 [{ROWS}]": mlp_runs[ROWS],
            "row 8 bf16 + residual": cases[0][1], "row 8 bf16, no residual": cases[1][1],
            "row 9 bf16 + residual": cases[2][1],
            "row 9 f32 in, no residual":
                lambda: fl.fused_residual_ln_quant(x32, None, lns, lnb, EPS, bf),
        }
        for turn in range(2):
            for vname, lib in libs.items():
                _build._lib = lib
                ms = {k: round(device_ms(fn, REPS), 4) for k, fn in timed.items()}
                print(f"variant {vname} (turn {turn}): {ms} [{card}]", flush=True)
        for vname, lib in libs.items():
            _build._lib = lib
            mlp_runs[ROWS]()
            wall, dev_ms, by_name = profile_window(mlp_runs[ROWS], 5)
            parts = {k: round(v / 5, 4) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
            print(f"variant {vname} row 10 [{ROWS}] by kernel, ms a call: {parts} [{card}]")
        _build._lib = lib_this
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
