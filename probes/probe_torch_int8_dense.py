"""The int8 dense (csrc/int8_dense.cu: ``ops.int8_dense``) on one card: the
kernel against the plain twin, bit for bit, and timed, beside the library.

    python3 probes/probe_torch_int8_dense.py [--quick] [--shapes M:N:K,...]

Run from the root of the checkout.  It prints, each line with the card's
name and power limit:

- registers, spills and shared memory of csrc/int8_dense.cu's kernels
  (``nvcc -Xptxas=-v``), and any ptxas warning (a serialized wgmma);
- at each shape (default: the encode cell's QKV and output denses at
  53,248 rows, the open cell's at 9,000, 40 rows, and the f32-carry
  tower's down dense): the kernel's y (bf16 and f32, from the given codes)
  equal to ``int8_dense_plain``'s or not, and its device ms
  (``chip_smoke.device_ms``; 40 rows take the 64-row tile, the others the
  128-row one); the row codes of bf16 and f32 rows against
  ``quantize_rows``; ``torch._int_mm`` alone and the whole parent
  composition (codes by ``quantize_rows`` where the dense takes none,
  ``_int_mm``, the dequantization, the bf16 cast), and the bound (the
  operations at 1,979 TOP/s or the bytes at 3.35 TB/s).

``--quick`` runs one shape and no timing (a first call after an edit).
``--variants`` builds csrc/int8_dense.cu alone under the text edits of
``VARIANTS`` into ``build/variants/dense-<name>`` and times each (called
through its own C interface, in turns with an unedited copy) at the
encode cell's QKV dense and the f32-carry tower's down dense: the parts
of a tile's time (no stores, no products) and other ring depths.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())

from chip_smoke import card_line, device_ms, int8_weight  # noqa: E402
from haconvdr_torch.index.quantize import quantize_rows  # noqa: E402
from haconvdr_torch.ops import _build, fused_mlp  # noqa: E402
from haconvdr_torch.ops import int8_dense as idn  # noqa: E402

SHAPES = [(53_248, 2304, 768), (53_248, 768, 768), (9_000, 2304, 768), (9_000, 768, 768),
          (40, 2304, 768), (53_248, 768, 3072)]
STORE = "if (wr0 + rr < M)\n"
# name -> [(old, new)] text edits of csrc/int8_dense.cu
VARIANTS = {
    "copy": [],
    # wrong answers, timed only: no stores of y (the products, the epilogue's
    # arithmetic and its staging stay), no products (the copies, the waits and
    # the stores stay), no epilogue at all
    "no-store": [(STORE, "if (wr0 + rr < 0)\n")],
    "no-mma": [("for (int k = 0; k < BK / 32; ++k) wgmma_s8(acc, da + 2 * k, db + 2 * k, 1);",
                "")],
    "no-epilogue": [("if (n0 + 64 * cc < N) {", "if (n0 + 64 * cc < N && acc[0] == 0x7fffffff) {")],
    "stages-3": [("launch_dense<2, 4, TO>", "launch_dense<2, 3, TO>")],
    "stages-5": [("launch_dense<2, 4, TO>", "launch_dense<2, 5, TO>")],
}


def ptxas_info() -> str:
    out_dir = Path("build/probe_int8_dense")
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-c", "-o", str(out_dir / "p.o"),
         str(_build.CSRC / "int8_dense.cu")], capture_output=True, text=True)
    info = proc.stdout + proc.stderr
    lines = [f"nvcc rc {proc.returncode}"]
    for block in re.split(r"ptxas info\s+: Compiling entry function", info)[1:]:
        name = block.split("'")[1] if "'" in block else "?"
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        lines.append(f"ptxas {name[:90]}: {regs.group(1) if regs else '?'} registers, "
                     f"{spill.group(1) if spill else '?'} spill bytes")
    lines += [ln for ln in info.splitlines() if "arning" in ln or "rror" in ln][:20]
    return "\n".join(lines)


def build_variant(name, edits):
    """csrc/int8_dense.cu (with ln_quant.cuh) under ``edits``, built alone into
    build/variants/dense-<name>/lib.so and loaded."""
    root = Path("build/variants") / f"dense-{name}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for f in ("int8_dense.cu", "ln_quant.cuh"):
        shutil.copy(_build.CSRC / f, root / f)
    src = root / "int8_dense.cu"
    text = src.read_text()
    for old, new in edits:
        if text.count(old) < 1:
            raise RuntimeError(f"variant {name}: {old!r} not found")
        text = text.replace(old, new)
    src.write_text(text)
    so = root / "lib.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.hc_int8_dense.argtypes = _build.SIGNATURES["hc_int8_dense"]
    lib.hc_int8_dense.restype = ctypes.c_int
    return lib


def run_variants(card: str) -> None:
    libs = {name: build_variant(name, edits) for name, edits in VARIANTS.items()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    for M, N, K in ((53_248, 2304, 768), (53_248, 768, 3072)):
        x = (torch.randn(M, K, device=dev, generator=g) * 2).to(torch.bfloat16)
        xq, xs = quantize_rows(x)
        w, ks = int8_weight(g, dev, N, K)
        b = torch.linspace(-0.1, 0.1, N, device=dev)
        y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)

        def call(lib):
            err = lib.hc_int8_dense(xq.data_ptr(), xs.data_ptr(), w.data_ptr(), ks.data_ptr(),
                                    b.data_ptr(), M, N, K, 1, y.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"hc_int8_dense: {err}")
        ms = {name: [] for name in libs}
        for _ in range(2):  # in turns
            for name, lib in libs.items():
                try:
                    ms[name].append(device_ms(lambda: call(lib), 20))
                except RuntimeError as e:
                    ms[name].append(float("nan"))
                    print(f"variant {name}: {e}")
        print(f"variants M {M} N {N} K {K}: " + ", ".join(
            f"{name} {min(v):.4f}" for name, v in ms.items()) + f" ms [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    card = card_line()
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} [{card}]")
    print(ptxas_info())
    _build.library()
    if args.variants:
        run_variants(card)
        return 0
    shapes = SHAPES if not args.shapes else [
        tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")]
    if args.quick:
        shapes = shapes[:1] + [(40, 2304, 768)]
    g = torch.Generator(device=dev).manual_seed(7)
    for M, N, K in shapes:
        x = (torch.randn(M, K, device=dev, generator=g) * 2).to(torch.bfloat16)
        xq, xs = quantize_rows(x)
        w, ks = int8_weight(g, dev, N, K)
        b = torch.linspace(-0.1, 0.1, N, device=dev)
        want = idn.int8_dense_plain(x, w, ks, b, (xq, xs), torch.bfloat16)
        flops, nbytes = 2.0 * M * N * K, M * K + N * K + 2.0 * M * N
        bound = max(flops / 1979e12, nbytes / 3.35e12) * 1e3
        print(f"shape M {M} N {N} K {K}: bound {bound:.4f} ms [{card}]")
        try:
            y = idn.int8_dense(x, w, ks, b, (xq, xs), torch.bfloat16)
            torch.cuda.synchronize()
            same32 = torch.equal(idn.int8_dense(x, w, ks, b, (xq, xs)),
                                 idn.int8_dense_plain(x, w, ks, b, (xq, xs)))
        except Exception as e:  # noqa: BLE001 - a probe reports the failure
            print(f"  FAILED {type(e).__name__}: {str(e)[:300]}")
            return 1
        print(f"  bf16 equal {torch.equal(y, want)} ({int((y != want).sum())} differ), "
              f"f32 equal {same32}")
        cq, cs = idn.row_codes(x)
        print(f"  row_codes bf16 equal {torch.equal(cq, xq) and torch.equal(cs, xs)}; f32 "
              f"equal {all(torch.equal(a, b2) for a, b2 in zip(idn.row_codes(x.float()), quantize_rows(x.float())))}")
        if args.quick:
            continue
        ms = device_ms(lambda: idn.int8_dense(x, w, ks, b, (xq, xs), torch.bfloat16), 20)
        auto_c = device_ms(lambda: idn.int8_dense(x, w, ks, b, None, torch.bfloat16), 20)
        codes = device_ms(lambda: idn.row_codes(x), 20)
        lib = device_ms(lambda: fused_mlp._int_mm(xq, w), 20)
        comp = device_ms(lambda: idn.int8_dense_plain(x, w, ks, b, (xq, xs), torch.bfloat16), 10)
        comp_c = device_ms(lambda: idn.int8_dense_plain(x, w, ks, b, None, torch.bfloat16), 10)
        qr = device_ms(lambda: quantize_rows(x), 10)
        print(f"  kernel {ms:.4f} ms ({100 * bound / ms:.1f}% of bound; with codes {auto_c:.4f}; row_codes {codes:.4f}); "
              f"torch._int_mm {lib:.4f}; parent composition {comp:.4f} (with quantize_rows "
              f"{comp_c:.4f}; quantize_rows {qr:.4f}) [{card}]")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
