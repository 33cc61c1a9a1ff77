"""The f32 attention kernels (rows 1, 11 and 12 of the port's queue 2)
against another checkout's, on one card, in one process.

    python3 probes/probe_torch_f32_attention.py [--other DIR] [--reps 20]

Run from the root of the checkout to measure.  It builds that checkout's
kernel library (``haconvdr_torch.ops._build``) and, with ``--other``, the
``haconvdr_torch/csrc`` of the checkout at DIR (for example an unpacked
parent) into ``build/variants/other`` with the same nvcc flags, loaded with
ctypes and swapped in as ``_build``'s library in turns.  It prints:

- each f32 attention kernel's registers and spill stores (ptxas -v);
- rows 11-12 in f32 (this checkout's kernels) against the plain twins at
  B 8 and B 64, L 512, ragged query lengths, dropout 0 and 0.1: max |diff|
  of the output and of dQ, dK and dV, held to 1e-5, and both the kernels'
  and the f32 twins' max |diff| from the twins run in float64;
- the same distances on the card tests' edge masks (tests/test_torch_cuda.py
  ``_tc_mask``: a full row, a prefix, holes, keys at both ends only, one
  valid key, none) at L 384 and 512, spread 1 and 3 (Q and K scaled),
  dropout 0 and 0.1, where the row without a valid key takes the f32
  twins as reference (float32 rounds its scores s - 1e9 to one value);
- row 1 in f32 (inference attention) at B 8 and B 64 against the other
  checkout's kernel on the same inputs: equal bit for bit or not, and
  against row 11's f32 forward at dropout 0 from this checkout;
- the ms a call (CUDA events) of row 11's forward and row 12's backward in
  f32 at dropout 0.1 and of row 1 in f32, other, this, this, other.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from haconvdr_torch.ops import _build  # noqa: E402
from haconvdr_torch.ops import flash_attention as fa  # noqa: E402
from haconvdr_torch.ops import fused_attention as fu  # noqa: E402

KERNELS = ("tf32_attention_fwd", "tf32_bwd_dq", "tf32_bwd_dkdv", "attn_f32_kernel",
           "fwd_kernel", "bwd_dq_kernel", "bwd_dkdv_kernel")


def ptxas_info(csrc: Path, out_dir: Path) -> str:
    """Registers and spill stores of each f32 attention kernel in csrc."""
    lines = []
    for src in ("fused_attention.cu", "flash_attention.cu"):
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-c", "-o",
             str(out_dir / "ptxas.o"), str(csrc / src)], capture_output=True, text=True)
        info = res.stdout + res.stderr
        for block in re.split(r"ptxas info\s+: Compiling entry function", info)[1:]:
            name = block.split("'")[1] if "'" in block else block[:200]
            found = [k for k in KERNELS if k in name]
            if not found:
                continue
            name = found[0] + {"ILb1E": "<true>", "ILb0E": "<false>"}.get(
                next((m for m in ("ILb1E", "ILb0E") if m in name), ""), "")
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            lines.append(f"{src} {name}: {regs.group(1) if regs else '?'} registers, "
                         f"{spill.group(1) if spill else '?'} bytes spill stores")
    return "\n".join(lines)


def build_copy(name: str, csrc: Path) -> ctypes.CDLL:
    """csrc copied to build/variants/<name>/csrc, built with the port's
    nvcc flags and loaded."""
    root = Path("build/variants") / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(csrc, root / "csrc")
    so = root / "lib.so"
    _build._compile_and_link(_build._nvcc(), sorted((root / "csrc").glob("*.cu")), root, so)
    return load(so)


def max_parts(a, b):
    """max |a - b| of the output [B, L, 768] or of dQ, dK and dV."""
    if a.shape[-1] == 768:
        return [float((a.double() - b.double()).abs().max())]
    return [float((a[..., i * 768:(i + 1) * 768].double() - b[..., i * 768:(i + 1) * 768]
                   .double()).abs().max()) for i in range(3)]


def load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hc_error_string.argtypes = [ctypes.c_int]
    lib.hc_error_string.restype = ctypes.c_char_p
    return lib


def cuda_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_f32_attention: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    this = _build.library()
    libs = {"this": this}
    scratch = Path("build/variants/ptxas")
    scratch.mkdir(parents=True, exist_ok=True)
    print("this:\n" + ptxas_info(_build.CSRC, scratch), flush=True)
    if args.other:
        libs["other"] = build_copy("other", Path(args.other) / "haconvdr_torch" / "csrc")
        print("other:\n" + ptxas_info(Path("build/variants/other/csrc"), scratch), flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    seed = (123457, -98765)
    cases = {}
    for B in (8, 64):
        L = 512
        lengths = rng.integers(L // 8 if B == 64 else 1, L + 1, B)
        lengths[0] = L
        mask = torch.from_numpy((np.arange(L)[None] < lengths[:, None]).astype(np.int32)).to(dev)
        qkv = torch.randn(B, L, 3 * 768, device=dev, generator=g) * 0.5
        go = torch.randn(B, L, 768, device=dev, generator=g)
        cases[B] = (qkv, mask, go)

    for B, (qkv, mask, go) in cases.items():
        for rate in (0.0, 0.1):
            ref = fa.flash_attention_fwd_plain(qkv, mask, 12, seed, rate)
            rdq = fa.flash_attention_bwd_plain(qkv, mask, go, 12, seed, rate)
            ref64 = fa.flash_attention_fwd_plain(qkv.double(), mask, 12, seed, rate)
            rdq64 = fa.flash_attention_bwd_plain(qkv.double(), mask, go.double(), 12, seed, rate)
            twin = max_parts(ref, ref64) + max_parts(rdq, rdq64)
            print(f"B {B} drop {rate}: f32 twins from float64: out, dQ, dK, dV "
                  + ", ".join(f"{e:.3e}" for e in twin)
                  + f"; largest |dV| {float(rdq64[..., 1536:].abs().max()):.3f} [{card}]",
                  flush=True)
            out, stats = fa._fwd_kernel(qkv, mask, 12, seed, rate)
            dq = fa._bwd_kernel(qkv, mask, stats, go, 12, seed, rate)
            torch.cuda.synchronize()
            e_t = max_parts(out, ref) + max_parts(dq, rdq)
            e_64 = max_parts(out, ref64) + max_parts(dq, rdq64)
            print("  kernels: from the f32 twins " + ", ".join(f"{e:.3e}" for e in e_t)
                  + f" (<= 1e-5: {max(e_t) <= 1e-5}); from float64 "
                  + ", ".join(f"{e:.3e}" for e in e_64) + f" [{card}]", flush=True)
            del out, stats, dq, ref, rdq, ref64, rdq64
        row1 = fu.fused_attention_qkv(qkv, mask, 12)
        same11 = torch.equal(row1, fa._fwd_kernel(qkv, mask, 12, None, 0.0)[0])
        line = f"row 1 f32 B {B}: equal to row 11's f32 forward at drop 0: {same11}"
        if "other" in libs:
            _build._lib = libs["other"]
            other = fu.fused_attention_qkv(qkv, mask, 12)
            _build._lib = this
            line += f"; equal to the other checkout's row 1: {torch.equal(row1, other)}"
        print(f"{line} [{card}]", flush=True)

    for L in (384, 512):
        mask = torch.zeros(6, L, dtype=torch.int32)
        mask[0] = 1
        mask[1, : 2 * L // 3] = 1
        mask[2, ::7] = 1
        mask[3, :5] = 1
        mask[3, L - 3:] = 1
        mask[4, L // 2] = 1
        mask = mask.to(dev)
        valid = mask.bool().any(1)[:, None, None]
        for spread in (1.0, 3.0):
            qkv = torch.randn(6, L, 3 * 768, device=dev, generator=g) * 0.5
            qkv[:, :, : 2 * 768] *= spread
            go = torch.randn(6, L, 768, device=dev, generator=g)
            for rate in (0.0, 0.1):
                out, stats = fa._fwd_kernel(qkv, mask, 12, seed, rate)
                dq = fa._bwd_kernel(qkv, mask, stats, go, 12, seed, rate)
                r32 = (fa.flash_attention_fwd_plain(qkv, mask, 12, seed, rate),
                       fa.flash_attention_bwd_plain(qkv, mask, go, 12, seed, rate))
                r64 = (fa.flash_attention_fwd_plain(qkv.double(), mask, 12, seed, rate),
                       fa.flash_attention_bwd_plain(qkv.double(), mask, go.double(), 12, seed,
                                                    rate))
                ref = [torch.where(valid, a, b.double()) for a, b in zip(r64, r32)]
                e_k = max_parts(out, ref[0]) + max_parts(dq, ref[1])
                e_t = max_parts(r32[0], ref[0]) + max_parts(r32[1], ref[1])
                print(f"edge masks L {L} spread {spread} drop {rate}: from float64 out, dQ, dK, "
                      "dV: kernels " + ", ".join(f"{e:.3e}" for e in e_k) + "; f32 twins "
                      + ", ".join(f"{e:.3e}" for e in e_t)
                      + f"; largest |dV| {float(ref[1][..., 1536:].abs().max()):.2f} [{card}]",
                      flush=True)
                del out, stats, dq, r32, r64, ref

    order = ["other", "this", "this", "other"] if "other" in libs else ["this", "this"]
    for B, (qkv, mask, go) in cases.items():
        for name in order:
            _build._lib = libs[name]
            _, stats = fa._fwd_kernel(qkv, mask, 12, seed, 0.1)
            fwd = cuda_ms(lambda: fa._fwd_kernel(qkv, mask, 12, seed, 0.1), args.reps)
            bwd = cuda_ms(lambda: fa._bwd_kernel(qkv, mask, stats, go, 12, seed, 0.1), args.reps)
            row1 = cuda_ms(lambda: fu.fused_attention_qkv(qkv, mask, 12), args.reps)
            print(f"{name} B {B}: row 11 f32 forward {fwd:.4f} ms, row 12 f32 backward "
                  f"{bwd:.4f} ms (drop 0.1); row 1 f32 {row1:.4f} ms [{card}]", flush=True)
    _build._lib = this
    return 0


if __name__ == "__main__":
    sys.exit(main())
