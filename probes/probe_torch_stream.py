"""The streaming top-k (row 7 of the port's queue 2) on one card, against
another checkout's streaming kernel.

    python3 probes/probe_torch_stream.py [--other DIR] [--qs 256] [--cases f32:100,...]
        [--geometries] [--rows 2498560]

Run from the root of the checkout to measure.  Over the first ``--rows``
(default 2,498,560, a multiple of 4,096) rows of a 2,500,000 x 768 index
made on the card from the seed (n_valid = rows - 1,000: chip_smoke.py
phase 3's row 7 shape), for each case of
``--cases`` (dtype:k; default float32 and bfloat16 at k 100, float32 at k
129 and 1,024) at each Q of ``--qs``, it prints, each line with the card's
name and power limit:

- with ``--other DIR``: DIR's streaming kernel (built with DIR's own
  ``_build.py``, called through its own C interface with the grid its
  wrapper computed: the parent's hc_topk_stream takes no spare array and
  its hc_topk_stream_qt only k, and its grid took about two blocks an SM
  over 64-row-multiple splits of at least 2,048 rows) and this checkout's,
  in device ms (calls queued behind a spin of the card,
  ``chip_smoke.device_ms``) in the order other, this, this, other, with
  the bound (2 Q n_valid D operations at the CUDA cores' f32 rate, the
  fmaf chain's) and ms / bound; the scores and ids of the two compared bit
  for bit;
- with ``--geometries``: this checkout's kernel past k 128 on other split
  counts than ``stream_plan`` gives (the v3 kernel's unseeded grid): two
  waves, as many splits as leave each at least 16 k rows, and a third of
  the splits, in turns, the answers bit for bit alike.

Any disagreement exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import PEAK, card_line, device_ms  # noqa: E402
from haconvdr_torch.ops import _build  # noqa: E402
from haconvdr_torch.ops import topk_stream as ts  # noqa: E402
from haconvdr_torch.ops.fused_topk import TILE_ROWS  # noqa: E402
from probe_torch_window import other_build  # noqa: E402

N_ROWS, N_STREAM, DIM, N_PAD = 2_500_000, 2_498_560, 768, 1_000
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def other_stream(lib, q, p, n_valid, k):
    """DIR's streaming kernel through its own C interface and its wrapper's
    grid (the parent's _n_splits over ceil(Q / hc_topk_stream_qt(k)) query
    tiles: about two blocks an SM, splits of at least 2,048 rows, a
    multiple of 64)."""
    dev = p.device
    q = q.to(p.dtype).contiguous()
    Q, D = q.shape
    N = p.shape[0]
    rows = max(0, min(int(n_valid), N))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_qt = -(-Q // lib.hc_topk_stream_qt(k))
    want = max(1, -(-2 * sms // n_qt))
    splits = max(1, min(want, max(1, rows // 2048), 65535))
    per = -(-max(rows, 1) // splits)
    per = -(-per // 64) * 64
    splits = -(-max(rows, 1) // per)
    cand = torch.empty((splits, Q, k), dtype=torch.int64, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    code = 0 if p.dtype == torch.float32 else 1
    err = lib.hc_topk_stream(q.data_ptr(), p.data_ptr(), Q, N, D, rows, k, per, splits,
                             cand.data_ptr(), code, stream)
    if err:
        raise RuntimeError(f"other hc_topk_stream: CUDA error {err}")
    if k <= 128:
        err = lib.hc_topk_merge(cand.data_ptr(), splits, Q, k, None, 0, out_s.data_ptr(),
                                out_i.data_ptr(), stream)
    else:
        err = lib.hc_topk_stream_merge(cand.data_ptr(), splits, Q, k, out_s.data_ptr(),
                                       out_i.data_ptr(), stream)
    if err:
        raise RuntimeError(f"other merge: CUDA error {err}")
    return out_s, out_i


def same_bits(a, b) -> bool:
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--qs", default="256")
    ap.add_argument("--cases", default="float32:100,bfloat16:100,float32:129,float32:1024")
    ap.add_argument("--geometries", action="store_true")
    ap.add_argument("--rows", type=int, default=N_STREAM)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_stream: needs a CUDA card", file=sys.stderr)
        return 2
    if not 0 < args.rows <= N_ROWS or args.rows % 4096:
        print(f"probe_torch_stream: --rows must be a multiple of 4,096 up to {N_ROWS}",
              file=sys.stderr)
        return 2
    card = card_line()
    lib = _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    p32 = torch.randn(N_ROWS, DIM, device=dev, generator=g)[:args.rows]
    index = {"float32": p32, "bfloat16": p32.to(torch.bfloat16)}
    n_valid = args.rows - N_PAD
    cases = [(c.split(":")[0], int(c.split(":")[1])) for c in args.cases.split(",")]
    lib_other = other_build(Path(args.other).resolve()).library() if args.other else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ok = True
    for Q in (int(x) for x in args.qs.split(",")):
        q = torch.randn(Q, DIM, device=dev, generator=g)
        b = 2.0 * Q * n_valid * DIM / PEAK["f32"] * 1e3
        for name, k in cases:
            p = index[name]
            run = lambda: ts.topk_block_v2(q, p, n_valid, k)  # noqa: E731
            mine = run()
            tag = f"topk_stream {name} Q {Q} k {k}"
            if lib_other is not None:
                theirs = other_stream(lib_other, q, p, n_valid, k)
                torch.cuda.synchronize()
                same = same_bits(mine, theirs)
                ok &= same
                reps = 3 if k <= 128 else 2
                ms = [device_ms(fn, reps) for fn in (
                    lambda: other_stream(lib_other, q, p, n_valid, k), run, run,
                    lambda: other_stream(lib_other, q, p, n_valid, k))]
                print(f"{tag}: other {ms[0]:.3f} / {ms[3]:.3f} ms, this {ms[1]:.3f} / "
                      f"{ms[2]:.3f} ms device ({ms[0] / ms[1]:.2f}x, {ms[3] / ms[2]:.2f}x); "
                      f"bound at the chain's rate {b:.3f} ms, this {ms[1] / b:.2f}x it; splits "
                      f"{ts.stream_plan(Q, k, n_valid, sms, p.dtype, lib)[1]}"
                      f"; bit-identical to the other's {same} [{card}]", flush=True)
            if args.geometries and k > 128:
                default = ts.split_geometry
                qb, base, _, _ = ts.stream_plan(Q, k, n_valid, sms, p.dtype, lib)
                tiles = -(-n_valid // TILE_ROWS)
                n_qt = -(-Q // qb)
                alts = {"default": base, "two waves": 2 * sms // n_qt,
                        "16 k rows a split": max(1, min(base, tiles // -(-16 * k // TILE_ROWS))),
                        "a third": max(1, base // 3)}
                times = {}
                for turn in range(2):
                    for alt, splits in alts.items():
                        per = -(-tiles // splits) * TILE_ROWS
                        ts.split_geometry = lambda *a, per=per: (-(-n_valid // per), per)
                        got = run()
                        torch.cuda.synchronize()
                        same = same_bits(got, mine)
                        ok &= same
                        times.setdefault(f"{alt} ({splits} splits)", []).append(
                            round(device_ms(run, 2), 3))
                        ts.split_geometry = default
                print(f"{tag} geometries (ms device, two turns): {times} [{card}]", flush=True)
        del q
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
