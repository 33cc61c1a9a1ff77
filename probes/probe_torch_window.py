"""The v4 window kernel (row 3 of the port's queue 2) on one card: its
routes, and against another checkout's window kernel.

    python3 probes/probe_torch_window.py [--other DIR] [--routes] [--ptxas] [--variants]
        [--only PREFIX]

Run from the root of the checkout to measure.  Over a 2,500,000 x 768
index made on the card from the seed (n_valid = N - 1,000, sw 256, as
chip_smoke.py phase 3), in float32, bfloat16 and int8 (the codes of
quantize_int8_torch, queries as their per-query int8 codes), it prints,
each line with the card's name and power limit:

- with ``--ptxas``: registers and spill stores of every kernel of
  csrc/topk_v4.cu (ptxas -v);
- with ``--routes``: every route of this checkout at Q 1, 8, 16, 32, 64
  and 256 in device ms (calls queued behind a spin of the card,
  ``chip_smoke.device_ms``), with the bytes bound and the bound at the
  route's rate, the panels of the routes compared bit for bit: the
  crossover ``ops/topk_v4.window_route`` takes;
- with ``--variants``: the routes under the text edits of ``VARIANTS``
  (stage depth, stages, rows of a block), each built into
  build/variants/<name>, timed in two turns beside this checkout's at the
  cases each names, its panels compared with this checkout's bit for bit;
- with ``--other DIR``: DIR's window kernel (built with DIR's own
  ``_build.py``, called through its own C interface, which must take the
  route as an argument, as this checkout's does) and this checkout's
  default route at Q 1, 8, 64, 256 and 512, in device ms in the order other,
  this, this, other; the panels (v1, a1, v2) of the two compared bit for
  bit, and this checkout's against ``rescore_windows`` bit for bit on
  each query's flagged windows and on random ones.

Any disagreement exits 1.
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

sys.path.insert(0, os.getcwd())

from chip_smoke import HBM_BYTES_PER_S, card_line, device_ms  # noqa: E402
from haconvdr_torch.index.quantize import quantize_int8_torch, quantize_queries_int8  # noqa: E402
from haconvdr_torch.ops import _build  # noqa: E402
from haconvdr_torch.ops import topk_v4 as v4  # noqa: E402

N_ROWS, DIM, N_PAD, TOP_K = 2_500_000, 768, 1_000, 100
AB_QS = (1, 8, 64, 256, 512)
ROUTE_QS = (1, 8, 16, 32, 64, 256)
ROUTES = {"float32": ("a", "b"), "bfloat16": ("a", "b"), "int8": ("a", "c")}
def edits(**kw):
    """Text edits of csrc/topk_v4.cu's constants: NAME=value."""
    return [("topk_v4.cu", re.compile(rf"constexpr int {k} = \d+;"), f"constexpr int {k} = {v};")
            for k, v in kw.items()]


def lit(old: str, new: str, src: str = "topk_v4.cu"):
    """A text edit of csrc/<src>: the one occurrence of ``old``."""
    return [(src, re.compile(re.escape(old)), new)]


# route B's main loop under text edits that take one part away (wrong
# answers; timed only): the shared-memory loads of the operands (values
# made in registers from the stage's address instead: the product of
# csrc/tile_fmaf.cuh, which row 2 shares), the copies after the first
# stages, the block barrier of each stage
B_NO_LDS = lit("x[i] = *reinterpret_cast<const float4*>(pr + 8 * i * FPP + 4 * d4);",
               "x[i] = make_float4((float)(uintptr_t)pr, (float)d4, (float)i, (float)lane);",
               "tile_fmaf.cuh") + lit(
    "const float4 w = *reinterpret_cast<const float4*>(qr + 4 * j * FPQ + 4 * d4);",
    "const float4 w = make_float4((float)(uintptr_t)qr, (float)d4, (float)j, (float)warp);",
    "tile_fmaf.cuh")
B_NO_REFILL = lit("if (st + K::STAGES - 1 < steps) fill_stage(", "if (false) fill_stage(")
B_NO_BARRIER = lit("__syncthreads();  // step st is in;", "__syncwarp();  // step st is in;")

# the routes under text edits of their constants (or of their main loop),
# each with the (route, Q) cases it is timed at
VARIANTS = {
    # route A: 64-byte stages three deep at every group (the first design),
    # the deep stages at 16 queries too, 256-byte stages, three deep stages,
    # 512 rows a block
    "a-shallow": (edits(A_DEEP_QA=0), [("a", 1), ("a", 8)]),
    "a-deep-at-16": (edits(A_DEEP_QA=16), [("a", 16)]),
    "a-deep-256": (edits(A_DEEP_CHUNK=256), [("a", 1), ("a", 8)]),
    "a-deep-3-stages": (edits(A_DEEP_STAGES=3), [("a", 1), ("a", 8)]),
    "a-rows512": (edits(A_BLOCK_ROWS=512), [("a", 1), ("a", 16)]),
    # route B: 64-byte stages (the first design: two blocks an SM too),
    # two blocks an SM (128 registers a thread), four stages, 256 rows a block
    "b-chunk64-2-blocks": (edits(B_CHUNK=64, B_MIN_BLOCKS=2), [("b", 64), ("b", 256)]),
    "b-2-blocks": (edits(B_MIN_BLOCKS=2), [("b", 64), ("b", 256)]),
    "b-4-stages": (edits(B_STAGES=4), [("b", 64), ("b", 256)]),
    "b-rows256": (edits(B_BLOCK_ROWS=256), [("b", 64), ("b", 256)]),
    "b-diag-no-lds": (B_NO_LDS, [("b", 256)]),
    "b-diag-no-refill": (B_NO_REFILL, [("b", 256)]),
    "b-diag-no-barrier": (B_NO_BARRIER, [("b", 256)]),
    "b-diag-fma-only": (B_NO_LDS + B_NO_REFILL, [("b", 256)]),
    # route C: 64-byte stages four deep (the first design), one block an SM,
    # 256 or 1,024 rows a block
    "c-chunk64-4-stages": (edits(C_CHUNK=64, C_STAGES=4), [("c", 64)]),
    "c-wide-chunk128-3-stages": (edits(C_WIDE_CHUNK=128, C_WIDE_STAGES=3), [("c", 256)]),
    "c-1-block": (edits(C_MIN_BLOCKS=1), [("c", 64), ("c", 256)]),
    "c-rows256": (edits(C_BLOCK_ROWS=256), [("c", 64), ("c", 256)]),
    "c-rows1024": (edits(C_BLOCK_ROWS=1024), [("c", 64), ("c", 256)]),
}


def build_variant(name: str, edit_list) -> ctypes.CDLL:
    """This checkout's csrc copied to build/variants/<name>/csrc with text
    edits [(file, pattern, new)], built with the port's nvcc flags and
    loaded."""
    root = Path("build/variants") / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root / "csrc")
    for fname, pattern, new in edit_list:
        f = root / "csrc" / fname
        text, n = pattern.subn(new, f.read_text())
        if n != 1:
            raise RuntimeError(f"variant {name}: {pattern.pattern!r} matched {n} times")
        f.write_text(text)
    so = root / "lib.so"
    _build._compile_and_link(_build._nvcc(), sorted((root / "csrc").glob("*.cu")), root, so)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hc_error_string.argtypes = [ctypes.c_int]
    lib.hc_error_string.restype = ctypes.c_char_p
    return lib


def other_build(root: Path):
    """DIR's own haconvdr_torch/ops/_build.py, loaded as a separate module."""
    spec = importlib.util.spec_from_file_location(
        "other_build", root / "haconvdr_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_info(csrc: Path, src: str = "topk_v4.cu") -> str:
    out_dir = Path("build/variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-c", "-o",
                          str(out_dir / "ptxas.o"), str(csrc / src)],
                         capture_output=True, text=True)
    info = res.stdout + res.stderr
    lines = []
    for block in re.split(r"ptxas info\s+: Compiling entry function", info)[1:]:
        name = block.split("'")[1] if "'" in block else block[:80]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        lines.append(f"ptxas {src} {name}: {regs.group(1) if regs else '?'} registers, "
                     f"{spill.group(1) if spill else '?'} bytes spill stores")
    return "\n".join(lines) if lines else info[-4000:]


def bounds(name: str, route: str, Q: int, p: torch.Tensor):
    """(bytes bound ms, bound at the route's rate ms, chip_smoke.window_bound)."""
    from chip_smoke import window_bound

    return (p.numel() * p.element_size() / HBM_BYTES_PER_S * 1e3,
            window_bound(route, name, Q, p, N_ROWS - N_PAD))


def other_window(lib, q, p, n_valid, sw):
    """DIR's window kernel through its own C interface, on the route this
    checkout's window_route names for Q (route 0 A, 1 B, 2 C; the kernel
    sizes its own grid)."""
    Q, D = q.shape
    N = p.shape[0]
    W = -(-N // sw)
    dev = p.device
    v1 = torch.empty((W, Q), dtype=torch.float32, device=dev)
    a1 = torch.empty((W, Q), dtype=torch.int32, device=dev)
    v2 = torch.empty((W, Q), dtype=torch.float32, device=dev)
    route = {"a": 0, "b": 1, "c": 2}[v4.window_route(Q, p.dtype, D)]
    err = lib.hc_window_top2(q.data_ptr(), p.data_ptr(), Q, N, D, n_valid, sw, W, route,
                             v1.data_ptr(), a1.data_ptr(), v2.data_ptr(),
                             {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[p.dtype],
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"other hc_window_top2: CUDA error {err}")
    return v1, a1, v2


def same_bits(x, y) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(x, y))


def rescore_agrees(q, p, panels, n_valid, sw, budget, g) -> bool:
    """rescore_windows on each query's flagged windows (the path's second
    select: v2 at or above the k-th window max, the largest `budget`) and
    on random ones: its max, lowest row of the max and second max equal
    the panels' bit for bit."""
    v1, a1, v2 = panels
    W, Q = v1.shape
    k = min(TOP_K, W)
    v_k = torch.topk(v1, k, dim=0).values[k - 1]
    flag = torch.where((v2 >= v_k[None, :]) & torch.isfinite(v2), v2, float("-inf"))
    fw = torch.topk(flag, budget, dim=0).indices.T.to(torch.int32)  # [Q, budget]
    rnd = torch.randint(0, W, (Q, 4), device=p.device, generator=g, dtype=torch.int32)
    win = torch.cat([fw, rnd], 1).contiguous()
    B = win.shape[1]
    resc = v4.rescore_windows(p, q, win, sw, n_valid).view(Q, B, sw)
    qi = torch.arange(Q, device=p.device)[:, None].expand(-1, B)
    w = win.long()
    top = resc.amax(2)
    pos = torch.where(resc == top[..., None], torch.arange(sw, device=p.device), sw).amin(2)
    second = resc.scatter(2, pos[..., None], float("-inf")).amax(2)
    return (same_bits((top, second), (v1[w, qi], v2[w, qi]))
            and torch.equal(pos + w * sw, a1[w, qi].long()))


def operands(dev, g, p32, scale, Q):
    q = torch.randn(Q, DIM, device=dev, generator=g)
    return {"float32": q, "bfloat16": q.to(torch.bfloat16),
            "int8": quantize_queries_int8(q * scale)[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--only", default="", help="variants whose name starts so")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_window: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    lib_this = _build.library()
    if args.ptxas:
        print(ptxas_info(_build.CSRC), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    p32 = torch.randn(N_ROWS, DIM, device=dev, generator=g)
    codes, scale = quantize_int8_torch(p32)
    index = {"float32": p32, "bfloat16": p32.to(torch.bfloat16), "int8": codes}
    n_valid = N_ROWS - N_PAD
    sw = v4.resolve_select_geometry(N_ROWS, torch.float32)[0]
    ok = True

    if args.routes:
        for Q in ROUTE_QS:
            qs = operands(dev, g, p32, scale, Q)
            for name, p in index.items():
                q = qs[name]
                got, line = {}, []
                for route in ROUTES[name]:
                    got[route] = v4.window_top2(q, p, n_valid, sw, route=route)
                    ms = device_ms(lambda: v4.window_top2(q, p, n_valid, sw, route=route),
                                   10 if Q <= 64 else 3)
                    b, rb = bounds(name, route, Q, p)
                    line.append(f"{route} {ms:.4f} ms ({ms / rb:.2f}x its bound {rb:.4f})")
                same = same_bits(*got.values())
                ok &= same
                print(f"routes {name} Q {Q}: " + ", ".join(line) + f"; bytes bound {b:.4f} ms; "
                      f"default {v4.window_route(Q, p.dtype)}; routes bit-identical {same} "
                      f"[{card}]", flush=True)
            del qs

    if args.variants:
        chosen = {k: v for k, v in VARIANTS.items() if k.startswith(args.only)}
        libs = {name: build_variant(name, ed) for name, (ed, _) in chosen.items()}
        cases = sorted({c for _, cs in chosen.values() for c in cs})
        for route, Q in cases:
            qs = operands(dev, g, p32, scale, Q)
            for name, p in index.items():
                if route not in ROUTES[name]:
                    continue
                q = qs[name]
                mine = [v for v, (_, cs) in chosen.items() if (route, Q) in cs]
                _build._lib = lib_this
                want = v4.window_top2(q, p, n_valid, sw, route=route)
                times = {}
                for turn in range(2):
                    for vname in ["this"] + mine:
                        _build._lib = lib_this if vname == "this" else libs[vname]
                        if turn == 0 and vname != "this" and "-diag-" not in vname:
                            ok &= same_bits(v4.window_top2(q, p, n_valid, sw, route=route), want)
                        times.setdefault(vname, []).append(round(device_ms(
                            lambda: v4.window_top2(q, p, n_valid, sw, route=route),
                            10 if Q <= 64 else 3), 4))
                _build._lib = lib_this
                b, rb = bounds(name, route, Q, p)
                print(f"variants route {route} {name} Q {Q} (bound at the route's rate "
                      f"{rb:.4f} ms): {times} [{card}]", flush=True)
            del qs

    if args.other:
        other = Path(args.other).resolve()
        lib_other = other_build(other).library()
        for Q in AB_QS:
            qs = operands(dev, g, p32, scale, Q)
            for name, p in index.items():
                q = qs[name]
                budget = v4.resolve_select_geometry(N_ROWS, p.dtype)[1]
                mine = v4.window_top2(q, p, n_valid, sw)
                theirs = other_window(lib_other, q, p, n_valid, sw)
                torch.cuda.synchronize()
                same = same_bits(mine, theirs)
                resc = rescore_agrees(q, p, mine, n_valid, sw, budget, g)
                ok &= same and resc
                reps = 10 if Q <= 64 else 3
                ms = [device_ms(fn, reps) for fn in (
                    lambda: other_window(lib_other, q, p, n_valid, sw),
                    lambda: v4.window_top2(q, p, n_valid, sw),
                    lambda: v4.window_top2(q, p, n_valid, sw),
                    lambda: other_window(lib_other, q, p, n_valid, sw))]
                route = v4.window_route(Q, p.dtype)
                b, rb = bounds(name, route, Q, p)
                print(f"window {name} Q {Q}: other {ms[0]:.4f} / {ms[3]:.4f} ms, this "
                      f"{ms[1]:.4f} / {ms[2]:.4f} ms device (route {route}; "
                      f"{ms[0] / ms[1]:.2f}x, {ms[3] / ms[2]:.2f}x); bound at the route's rate "
                      f"{rb:.4f} ms (bytes {b:.4f}), this {ms[1] / rb:.2f}x it; panels "
                      f"bit-identical to the other's {same}, to rescore_windows {resc} "
                      f"[{card}]", flush=True)
            del qs
    _build._lib = lib_this
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
