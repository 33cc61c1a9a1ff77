#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (haconvdr_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root, with one CUDA card visible.  Phases, in
order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile haconvdr_torch/csrc/*.cu with nvcc into
   build/haconvdr_torch/ (first use) and print the build time;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card at
   the serving path's shapes, with the max error and both times;
4. main path: a full-width ANCE RoBERTa-base query tower (random weights
   from the seed) over a resident 2,500,000 x 768 float32 index made on
   the card; a BatchingRetriever(max_batch=64) answers concurrent
   conversational requests and Retriever.retrieve a few single ones.
   Every answer is held against the plain twins' answer for the same
   queries, and each kernel must have launched on this path while no
   plain twin ran.

Tolerances (kernel vs plain twin on the same inputs):
  attention float32  max |diff| <= 1e-4
  attention bfloat16 |diff| <= 2**-6 + 2**-8 |ref| (one bf16 ulp: both
                     round P and the output to bf16)
  top-k scores       |diff| <= 1e-4 |ref| (float32 and bfloat16: both
                     accumulate exact products in float32)
  top-k ids          identical wherever the adjacent scores differ by
                     more than 1e-5 |s| (below that a summation-order
                     difference may swap two near-equal rows)

The line before the last is the card's nvidia-smi name and power limit;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_ROWS = 2_500_000
N_PAD = 1_000  # rows past n_valid in phase 3
DIM = 768
TOP_K = 100
Q_KERNEL = 256
ATTN_B, ATTN_L = 8, 512
N_BATCHED = 128  # two full max_batch=64 dispatches
N_SINGLE = 4
WORDS = [f"w{i}" for i in range(5000)]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def separated(scores: torch.Tensor) -> torch.Tensor:
    """[Q, k] mask of positions whose neighbours differ by > 1e-5 |s|."""
    s = scores.double()
    gap = (s[:, :-1] - s[:, 1:]).abs() > 1e-5 * s[:, 1:].abs()
    gap = gap | torch.isinf(s[:, 1:])
    ones = torch.ones_like(gap[:, :1])
    return torch.cat([ones, gap], 1) & torch.cat([gap, ones], 1)


def compare_topk(s, i, rs, ri, what: str) -> float:
    """Hold (s, i) against the plain twin's (rs, ri); returns max |diff|."""
    s, rs = s.double(), rs.double()
    fin = torch.isfinite(rs)
    check(torch.equal(fin, torch.isfinite(s)), f"{what}: -inf slots differ")
    err = (s[fin] - rs[fin]).abs()
    check(bool((err <= 1e-4 * rs[fin].abs()).all()), f"{what}: scores beyond 1e-4 rel")
    sep = separated(rs)
    check(torch.equal(i[sep], ri[sep]), f"{what}: ids differ at separated scores")
    return float(err.max()) if err.numel() else 0.0


def phase_kernels(seed: int, dev, passages_f32):
    from haconvdr_torch.ops.fused_attention import (
        fused_attention_qkv,
        fused_attention_qkv_plain,
    )
    from haconvdr_torch.ops.fused_topk import fused_topk_block, fused_topk_block_plain

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)
    rows = []
    # -- attention at B=8, L=512, H=768, 12 heads, random padding lengths
    lengths = rng.integers(1, ATTN_L + 1, ATTN_B)
    lengths[0] = ATTN_L
    mask = torch.from_numpy(
        (np.arange(ATTN_L)[None, :] < lengths[:, None]).astype(np.int32)
    ).to(dev)
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        qkv = torch.randn(ATTN_B, ATTN_L, 3 * DIM, device=dev, generator=g).to(dt)
        out = fused_attention_qkv(qkv, mask, 12)
        torch.cuda.synchronize()
        ref = fused_attention_qkv_plain(qkv, mask, 12)
        diff = (out.float() - ref.float()).abs()
        if dt == torch.float32:
            check(float(diff.max()) <= 1e-4, f"attention {name}: {float(diff.max())}")
        else:
            check(
                bool((diff <= 2.0**-6 + 2.0**-8 * ref.float().abs()).all()),
                f"attention {name}: beyond one bf16 ulp ({float(diff.max())})",
            )
        ms = cuda_ms(lambda: fused_attention_qkv(qkv, mask, 12), reps=10)
        pms = cuda_ms(lambda: fused_attention_qkv_plain(qkv, mask, 12), reps=10)
        rows.append(dict(kernel="fused_attention", config=name, max_abs_err=float(diff.max()),
                         ms=ms, plain_ms=pms, shape=[ATTN_B, ATTN_L, 3 * DIM]))
        del qkv, out, ref
    # -- fused top-k at Q=256, N=2.5M (n_valid = N - 1000), D=768, k=100
    q = torch.randn(Q_KERNEL, DIM, device=dev, generator=g)
    extra = torch.randn(100_000, DIM, device=dev, generator=g)
    seed_scores = torch.topk(q @ extra.T, TOP_K, dim=1).values.contiguous()
    del extra
    n_valid = N_ROWS - N_PAD
    for name in ("float32", "bfloat16"):
        p = passages_f32 if name == "float32" else passages_f32.to(torch.bfloat16)
        for seeded in (False, True):
            init = seed_scores if seeded else None
            s, i = fused_topk_block(q, p, n_valid, TOP_K, init_scores=init)
            torch.cuda.synchronize()
            rs, ri = fused_topk_block_plain(q, p, n_valid, TOP_K, init_scores=init)
            tag = f"top-k {name}{' seeded' if seeded else ''}"
            err = compare_topk(s, i, rs, ri, tag)
            check(int(i.max()) < n_valid, f"{tag}: a row past n_valid surfaced")
            if seeded:
                check(bool((i == -1).any()), f"{tag}: no seed survivor")
            ms = cuda_ms(lambda: fused_topk_block(q, p, n_valid, TOP_K, init_scores=init), 3)
            pms = cuda_ms(
                lambda: fused_topk_block_plain(q, p, n_valid, TOP_K, init_scores=init), 3
            )
            rows.append(dict(kernel="fused_topk", config=tag[6:], max_abs_err=err, ms=ms,
                             plain_ms=pms, shape=[Q_KERNEL, N_ROWS, DIM, TOP_K]))
        del p
    torch.cuda.empty_cache()
    return rows


def make_requests(seed: int, n: int):
    """Conversational requests with 0-4 history turns, drawn from the seed."""
    rng = np.random.default_rng(seed + 2)

    def text(lo, hi):
        return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))

    reqs = []
    for _ in range(n):
        turns = int(rng.integers(0, 5))
        history = [(text(4, 12), text(2, 30)) for _ in range(turns)]
        passages = [text(40, 120) if rng.random() < 0.5 else "" for _ in range(turns)]
        reqs.append((text(4, 14), history, passages))
    return reqs


def phase_main_path(seed: int, dev, passages_f32, card: str):
    from haconvdr_tpu.config import DataConfig, ModelConfig, SearchConfig
    from haconvdr_tpu.data.loader import batch_iter
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.ops import fused_attention, fused_topk
    from haconvdr_torch.parallel.sharded_encode import encode_batches
    from haconvdr_torch.serve import BatchingRetriever, Retriever
    from haconvdr_torch.utils.testing import HashTokenizer

    cfg = ModelConfig()  # ANCE RoBERTa-base: 12 x 768, 12 heads, 3072, 50265
    t0 = time.perf_counter()
    params = init_params_numpy(cfg, seed)
    offset2pid = np.arange(N_ROWS, dtype=np.int64) * 7 + 11
    retriever = Retriever(
        HashTokenizer(cfg.vocab_size), params, cfg, passages_f32,
        offset2pid=offset2pid,
        data_cfg=DataConfig(is_train=False, use_PRL=False),  # max_concat_length 512
        search_cfg=SearchConfig(top_k=TOP_K, per_device_test_batch_size=64),
        device=dev,
    )
    print(f"main path: set up in {time.perf_counter() - t0:.1f} s "
          f"(params {cfg.num_hidden_layers}x{cfg.hidden_size}, index {N_ROWS}x{DIM} f32)")
    reqs = make_requests(seed, N_BATCHED + N_SINGLE)
    batched_reqs, single_reqs = reqs[:N_BATCHED], reqs[N_BATCHED:]

    for mod in (fused_attention, fused_topk):
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    # ---- the main path: warm-up, concurrent batched requests, singles
    retriever.retrieve(*single_reqs[0])
    answers = [None] * N_BATCHED
    latency = [0.0] * N_BATCHED
    with BatchingRetriever(retriever, max_batch=64, max_wait_ms=50.0) as batcher:

        def client(idx):
            t = time.perf_counter()
            answers[idx] = batcher.submit(*batched_reqs[idx]).result(timeout=600)
            latency[idx] = time.perf_counter() - t

        threads = [threading.Thread(target=client, args=(j,)) for j in range(N_BATCHED)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        stats = batcher.stats()
    check(all(not t.is_alive() for t in threads), "batched clients did not finish")
    singles, single_lat = [], []
    for req in single_reqs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        singles.append(retriever.retrieve(*req))
        single_lat.append(time.perf_counter() - t)
    counts = {"fused_attention": dict(fused_attention.COUNTS),
              "fused_topk": dict(fused_topk.COUNTS)}
    # ---- end of the main path
    print("main path launch counts:", json.dumps(counts))
    for name, c in counts.items():
        check(c["kernel"] > 0, f"{name}: kernel never launched on the main path")
        check(c["plain"] == 0, f"{name}: plain twin ran on the main path")
    print(f"batched: {N_BATCHED} requests in {wall * 1e3:.1f} ms -> "
          f"{N_BATCHED / wall:.2f} QPS; latency p50 {np.median(latency) * 1e3:.1f} ms, "
          f"max {max(latency) * 1e3:.1f} ms; dispatches {stats['dispatches']} "
          f"{stats['batch_histogram']} [{card}]")
    print(f"single Retriever.retrieve latency ms: "
          f"{[round(x * 1e3, 2) for x in single_lat]} [{card}]")

    # ---- plain-twin reference for the same queries, on the card
    ref_enc = AnceEncoder.from_jax_params(
        params, cfg, dev, attention=fused_attention.fused_attention_qkv_plain
    )
    examples = [retriever.build_query(*r) for r in batched_reqs + single_reqs]
    ref_q, _ = encode_batches(ref_enc, batch_iter(examples, 64), "conv_qp", "conv_qp_mask")
    got_q = retriever.embed(examples)  # per_device_test_batch_size 64
    emb_err = float(np.abs(ref_q - got_q).max())
    check(np.isfinite(got_q).all() and got_q.shape == (len(examples), cfg.embedding_dim),
          "query embeddings not finite or of the wrong shape")
    check(emb_err <= 1e-3, f"query embeddings: kernel vs plain {emb_err}")
    rs, ri = fused_topk.fused_topk_block_plain(
        torch.from_numpy(ref_q).to(dev), passages_f32, N_ROWS, TOP_K
    )
    ri_pid = torch.from_numpy(offset2pid[ri.cpu().numpy()])
    got = answers + singles
    for j, ans in enumerate(got):
        check(ans is not None and len(ans) == TOP_K, f"request {j}: {len(ans or [])} hits")
        s = torch.tensor([[x[1] for x in ans]])
        i = torch.tensor([[x[0] for x in ans]])
        compare_topk(s, i, rs[j : j + 1].cpu(), ri_pid[j : j + 1], f"request {j}")
    print(f"main path answers match the plain twins for {len(got)} requests "
          f"(query embedding max |diff| {emb_err:.3g})")
    return counts, dict(batched_qps=N_BATCHED / wall, batched_p50_ms=np.median(latency) * 1e3,
                        single_ms=[x * 1e3 for x in single_lat])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2

    from haconvdr_torch.device import resolve_device
    from haconvdr_torch.ops import _build

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    _build.library()
    print(f"build: {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s "
          f"nvcc (0 = loaded from build/haconvdr_torch/)")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    passages = torch.randn(N_ROWS, DIM, device=dev, generator=g)
    rows = phase_kernels(args.seed, dev, passages)
    for r in rows:
        print("kernel vs plain:", json.dumps(r), f"[{card}]")

    counts, e2e = phase_main_path(args.seed, dev, passages, card)
    print("e2e:", json.dumps(e2e), f"[{card}]")

    def entry(name, source, replaces):
        mine = [r for r in rows if r["kernel"] == name]
        main_row = mine[0]  # float32, unseeded: the main path's configuration
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name]["kernel"],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"]}

    print(json.dumps({"kernels": [
        entry("fused_attention", "haconvdr_torch/csrc/fused_attention.cu",
              "haconvdr_tpu/ops/fused_attention.py:30"),
        entry("fused_topk", "haconvdr_torch/csrc/fused_topk.cu",
              "haconvdr_tpu/ops/pallas_topk.py:63"),
    ]}))
    print(f"total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
