"""Build ``haconvdr_torch/csrc/*.cu`` with nvcc at first use and load it.

The sources expose a plain C interface (no torch headers), so each builds
in seconds: one nvcc per source, all started together, then one link.
The shared library goes to ``build/haconvdr_torch/<hash>/`` under the
checkout root, keyed on a hash of the sources, their headers and the
flags: an edited kernel rebuilds, an unchanged one loads.  Any failure
(no nvcc, a compile error, a load error) raises.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
# C entry points: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # qkv, mask(int32), out, B, L, H, num_heads, dtype(0 f32 / 1 bf16), stream
    "hc_fused_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, p, Q, N, D, n_valid, k, thr(float[Q] or NULL), rows_per_split,
    # n_splits, cand_keys(uint64 [S, Q, k]), dtype, stream
    "hc_topk_split": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P],
    # Q, k, dtype -> queries per block of hc_topk_split (0: k or dtype refused)
    "hc_topk_split_qb": [_I, _I, _I],
    # q, p, Q, N, D, n_valid, k, qb (64 or 128), rows_per_split, n_splits,
    # cand_keys(uint64 [S, Q, k]), spare(uint64 [S, Q, k] past k 128, else
    # NULL), dtype, stream
    "hc_topk_stream": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # cand_keys(uint64 [S, Q, k]), n_splits, Q, k (128 < k <= 1024),
    # out_scores(float [Q, k]), out_ids(int32 [Q, k]), stream
    "hc_topk_stream_merge": [_P, _I, _I, _I, _P, _P, _P],
    # cand_keys, n_splits, Q, k, seed(float [Q, ks] or NULL), ks,
    # out_scores(float [Q, k]), out_ids(int32 [Q, k]), stream
    "hc_topk_merge": [_P, _I, _I, _I, _P, _I, _P, _P, _P],
    # q, p, Q, N, D, n_valid, sw, W, route (0 A, 1 B, 2 C),
    # v1(float [W, Q]), a1(int32 [W, Q]), v2(float [W, Q]), mode, stream
    "hc_window_top2": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # q, p, Q, N, D, n_valid, sw, B, win_ids(int32 [Q, B]),
    # out(float [Q, B * sw]), mode, stream
    "hc_rescore_windows": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # scores, ids(int32 or NULL), floor(float [Q] or NULL), Q, C, stride_q,
    # stride_c, k, out_scores(float [Q, k]), out_ids(int32 [Q, k]), stream
    "hc_select_topk": [_P, _P, _P, _I, _I, _L, _L, _I, _P, _P, _P],
    # the same, split `splits` ways along each query: ..., k, splits,
    # cand_scores(float [Q, splits * k]), cand_ids(int32 [Q, splits * k]),
    # out_scores, out_ids, stream
    "hc_select_topk_split": [_P, _P, _P, _I, _I, _L, _L, _I, _I, _P, _P, _P, _P, _P],
    # x, residual (or NULL), scale, bias, eps, rows, H, x dtype, out dtype
    # (0 f32 / 1 bf16), y, yq (int8 or NULL), ys (float [rows] or NULL), stream
    "hc_fused_ln": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _P, _P, _P, _P],
    # x, xq, xs, w1, s1, b1, w2, s2, b2, ln scale, ln bias, eps, rows, H, I,
    # y, yq, ys, scratch g, gmax, gq, gs, t, stream
    "hc_fused_mlp": [_P] * 11 + [_F, _I, _I, _I] + [_P] * 9,
    # row 10's split mode: xq, xs, w1, s1, b1, rows, H, I (the rank's), g,
    # gmax, stream
    "hc_fused_mlp_split_up": [_P] * 5 + [_I, _I, _I] + [_P] * 3,
    # g, gmax (the group's), w2, rows, H, I, scratch gq, gs, part(int32
    # [rows, H]), stream
    "hc_fused_mlp_split_down": [_P] * 3 + [_I, _I, _I] + [_P] * 4,
    # part(int32 [tp, rows, H]), tp, gs, x, s2, b2, ln scale, ln bias, eps,
    # rows, H, scratch t, y, yq, ys, stream
    "hc_fused_mlp_split_finish": [_P, _I] + [_P] * 6 + [_F, _I, _I] + [_P] * 5,
    # qkv, mask(int32), out, stats(float2 [B, nh, L]), B, L, H, num_heads,
    # dtype, drop_on, seed0, seed1, keep threshold, 1 / (1 - rate), row0
    # (the first row's index in the whole batch), stream
    "hc_flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _U, _F, _I, _P],
    # qkv, mask, dout, stats, dvec(float [B, nh, L] scratch), dqkv, B, L, H,
    # num_heads, dtype, drop_on, seed0, seed1, keep threshold, 1 / (1 - rate),
    # row0, stream
    "hc_flash_bwd": [_P] * 6 + [_I] * 8 + [_U, _F, _I, _P],
    # logits(float [T, E]), T, E, k, scale, counts(int32 [E]),
    # perm_tok(int32 [E, cap]), perm_w(float [E, cap]), cap, stream
    "hc_moe_route": [_P, _I, _I, _I, _F, _P, _P, _P, _I, _P],
    # mode (0 up, 1 down), A, W, counts, perm_tok, perm_w, cap, E, N, K,
    # M tiles, out, loads(int64 [E] or NULL), max_sum(int64 [1] or NULL), stream
    "hc_moe_gemm": [_I] + [_P] * 5 + [_I] * 5 + [_P] * 4,
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


def _compile_and_link(nvcc: str, sources, out_dir: Path, so: Path) -> None:
    """One nvcc per source, run at once, then one link into ``so``
    (written under a temporary name and renamed into place)."""
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs = [out_dir / f".{src.stem}-{tag}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    logs = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append((src, proc.returncode, out))
    tmp = out_dir / f".tmp-{tag}.so"
    try:
        failed = [(src, rc, log) for src, rc, log in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{src.name} (rc {rc}):\n{log[-6000:]}" for src, rc, log in failed
            ))
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (rc {proc.returncode}):\n{(proc.stdout + proc.stderr)[-6000:]}"
            )
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


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
        out_dir = BUILD_ROOT / _digest(sources + sorted(CSRC.glob("*.cuh")))
        so = out_dir / "libhaconvdr_kernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _compile_and_link(_nvcc(), sources, out_dir, so)
            build_seconds = time.perf_counter() - t0
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
