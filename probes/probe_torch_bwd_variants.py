"""Row 12's bf16 backward (``haconvdr_torch/csrc/attention_tc_bwd.cuh``)
under build variants, timed in turns on one card.

Each variant is the port's kernel sources copied to
``build/variants/<name>/csrc`` with text edits, built with the port's own
nvcc flags, loaded with ctypes and swapped in as
``haconvdr_torch.ops._build``'s library.  Variants:

    minb3   the sources as they are (tc_bwd_dq at three blocks an SM)
    minb2   tc_bwd_dq at two blocks an SM
    keep3   every cp.async of attention_tc.cuh with an L2 evict_last policy
    keep2   both edits

At chip_smoke.py phase 9's shape (B 64, L 512, query lengths 64-512,
dropout 0.1) each variant's dqkv must equal the sources' bit for bit.  It
prints each variant's registers and spill stores of tc_bwd_dq (ptxas -v),
its ms a call (CUDA events over 30 calls) in the order minb3 minb2 keep3
keep2 keep2 keep3 minb2 minb3, and each kernel's device ms a call
(torch.profiler over 10 calls), with the card's name and power limit.
Run from the repo root on the card:

    python3 probes/probe_torch_bwd_variants.py
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from haconvdr_torch.ops import _build  # noqa: E402
from haconvdr_torch.ops import flash_attention as fa  # noqa: E402

MINB = ("__launch_bounds__(TC_NT, 3) tc_bwd_dq", "__launch_bounds__(TC_NT, 2) tc_bwd_dq")
KEEP = (
    '''  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));''',
    '''  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n" : "=l"(pol));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0), "l"(pol));''',
)
VARIANTS = {
    "minb3": [],
    "minb2": [("attention_tc_bwd.cuh", MINB)],
    "keep3": [("attention_tc.cuh", KEEP)],
    "keep2": [("attention_tc_bwd.cuh", MINB), ("attention_tc.cuh", KEEP)],
}
ORDER = ["minb3", "minb2", "keep3", "keep2", "keep2", "keep3", "minb2", "minb3"]


def build(name: str, edits, out: dict) -> None:
    root = Path("build/variants") / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root / "csrc")
    for fname, (old, new) in edits:
        f = root / "csrc" / fname
        text = f.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor is not once in {fname}")
        f.write_text(text.replace(old, new))
    so = root / "lib.so"
    _build._compile_and_link(_build._nvcc(), sorted((root / "csrc").glob("*.cu")), root, so)
    ptx = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-c", "-o", str(root / "fa.o"),
         str(root / "csrc" / "flash_attention.cu")], capture_output=True, text=True)
    info = ptx.stdout + ptx.stderr
    at = info.find("tc_bwd_dq")
    regs = re.search(r"Used (\d+) registers", info[at:]) if at >= 0 else None
    spill = re.search(r"(\d+) bytes spill stores", info[at:]) if at >= 0 else None
    out[name] = (so, regs.group(1) if regs else "?", spill.group(1) if spill else "?")


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    built: dict = {}
    threads = [threading.Thread(target=build, args=(n, e, built)) for n, e in VARIANTS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {}
    for name in VARIANTS:
        if name not in built:
            print(f"{name}: did not build", flush=True)
            continue
        so, regs, spill = built[name]
        libs[name] = load(so)
        print(f"{name}: tc_bwd_dq {regs} registers, {spill} bytes spill stores", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, L = 64, 512
    lengths = np.random.default_rng(0).integers(L // 8, L + 1, B)
    lengths[0] = L
    mask = torch.from_numpy((np.arange(L)[None] < lengths[:, None]).astype(np.int32)).to(dev)
    qkv = (torch.randn(B, L, 3 * 768, device=dev, generator=g) * 0.5).to(torch.bfloat16)
    go = torch.randn(B, L, 768, device=dev, generator=g).to(torch.bfloat16)
    seed, rate = (3, 4), 0.1
    _build._lib = libs["minb3"]
    _, stats = fa._fwd_kernel(qkv, mask, 12, seed, rate)
    ref = fa._bwd_kernel(qkv, mask, stats, go, 12, seed, rate)

    def bwd():
        return fa._bwd_kernel(qkv, mask, stats, go, 12, seed, rate)

    for name in ORDER:
        if name not in libs:
            continue
        _build._lib = libs[name]
        same = torch.equal(bwd(), ref)
        print(f"{name}: {cuda_ms(bwd, 30):.4f} ms, dqkv equal to minb3's: {same} [{card}]",
              flush=True)
    for name in libs:
        _build._lib = libs[name]
        bwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                bwd()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = "tc_bwd_dkdv" if "tc_bwd_dkdv" in e.name else (
                    "tc_bwd_dq" if "tc_bwd_dq" in e.name else e.name[:30])
                per[key] = per.get(key, 0.0) + e.time_range.elapsed_us() / 1e4
        print(f"{name} device ms a call: {({k: round(v, 4) for k, v in per.items()})} [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
