"""Build ``haconvdr_torch/csrc/*.cu`` with nvcc at first use and load it.

The sources expose a plain C interface (no torch headers), so one nvcc
call builds every kernel in seconds.  The shared library goes to
``build/haconvdr_torch/<hash>/`` under the checkout root, keyed on a hash
of the sources and flags: an edited kernel rebuilds, an unchanged one
loads.  Any failure (no nvcc, a compile error, a load error) raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "haconvdr_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # qkv, mask(int32), out, B, L, H, num_heads, dtype(0 f32 / 1 bf16), stream
    "hc_fused_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, p, Q, N, D, n_valid, k, thr(float[Q] or NULL), rows_per_split,
    # n_splits, cand_keys(uint64 [S, Q, k]), dtype, stream
    "hc_topk_split": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P],
    # cand_keys, n_splits, Q, k, seed(float [Q, ks] or NULL), ks,
    # out_scores(float [Q, k]), out_ids(int32 [Q, k]), stream
    "hc_topk_merge": [_P, _I, _I, _I, _P, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last nvcc run


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "haconvdr_torch cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Thread-safe; a
    concurrent build by another process is tolerated (atomic rename)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        out_dir = BUILD_ROOT / _digest(sources)
        so = out_dir / "libhaconvdr_kernels.so"
        if not so.exists():
            nvcc = _nvcc()
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".tmp-{os.getpid()}-{threading.get_ident()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                log = proc.stdout + proc.stderr
                raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{log[-8000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hc_error_string.argtypes = [ctypes.c_int]
        lib.hc_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = _lib.hc_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
