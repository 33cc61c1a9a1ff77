#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (haconvdr_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root, with one CUDA card visible.  Phases, in
order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile haconvdr_torch/csrc/*.cu with nvcc into
   build/haconvdr_torch/ (first use; one nvcc per source, run at once)
   and print the build time;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card at
   the serving path's shapes (Q = 256, N = 2,500,000 with n_valid =
   N - 1,000, D = 768, k = 100), with the max error and both times:
   attention; the v3 top-k in f32, bf16 and its int8 mode, unseeded and
   seeded; the v4 window and rescore kernels; the select kernel in both
   layouts, cold at the path's pool [W + 8 sw, Q] and warm (a floor from
   warm_floor) at the wider pool of a 1.7M-row search, where it must also
   equal the cold answer; the whole v4 search in f32, bf16 and int8, and a
   forced fallback to v3 (planted duplicate rows); the int8 tower's kernels
   at the corpus-encode batch (256 x 384 = 98,304 rows, H 768, I 3072):
   LayerNorm with a bf16 residual and without one, LayerNorm-quant with a
   bf16 residual and with a float32 input and none, and the int8 MLP
   block; the trained
   tower's flash-attention forward and backward at B 8, L 512, 12 heads,
   float32 and bfloat16, dropout 0 and 0.1, and at phase 9's shape (B 64,
   query lengths 64-512, bfloat16, dropout 0.1; the same seed words to
   both);
   each row also carries its bound (bytes over 3.35 TB/s or operations
   over the peak of the type the work could run in) and, where one
   PyTorch call computes the same function, that call's time;
4. main path: a full-width ANCE RoBERTa-base query tower (random weights
   from the seed) over a resident 2,500,000 x 768 float32 index made on
   the card, searched by the v4 kernels; a BatchingRetriever(max_batch=64)
   answers concurrent conversational requests and Retriever.retrieve a
   few single ones.  Answers are held against the plain twins;
5. int8 resident path: the same tower, Retriever(store_dtype="int8") over
   the same rows quantized on the card; 64 concurrent requests and a few
   single ones.  Every search's answer equals the plain int8 scoring of
   the same query embeddings: ids at every position, scores bit for bit;
6. streaming path: BlockSearcher over the same rows as four 625,000-row
   device blocks: per block (unseeded v3 first, then seeded v3), and as
   super-blocks of 2,500,000 rows (one v4 search per fill) in float32 and
   with the int8 accumulator.  Answers are held against the plain twins.
7. int8 tower serving: Retriever(encoder_int8=True) with
   ModelConfig(dtype="bfloat16") over the phase-4 index; 64 concurrent
   requests and a few single ones.  Each forward launches LayerNorm-quant
   13 times and the MLP kernel 12 times; the searches equal the plain
   search of the same embeddings, and the embeddings agree with the
   plain-twin tower on the same batches;
8. corpus encode: encode_corpus through the same int8 bf16 tower over
   2,048 passages (lengths 32-384, seed), batch 256, blocks of 1,024, into
   int8 blocks.  Offsets come out in corpus order, each block's codes equal
   quantize_int8 of the tower's float rows, and the rows agree with the
   plain-twin tower run through the same encode_corpus;
9. training at the reference geometry (B 64, query length 512, passage
   length 384, ModelConfig(dtype="bfloat16", remat="mlp"), dropout 0.1,
   TrainConfig(is_pseudo_prepos=True, is_prepos_neg=True,
   frozen_dtype="int8"): four int8 frozen towers a step) on seeded random
   weights and batches: (a) one micro step with the trained tower through
   the kernels and one through its plain twins, from the same state,
   batch and generator seed (at B 16; the int8 frozen towers run their
   kernels on both sides), loss and gradients compared, and a third step
   through the kernels with other dropout draws, which must land outside
   the gradient bound; (b) TRAIN_MICRO micro steps of make_train_step
   with accumulation_steps 2 on one repeated batch: the loss falls, the
   frozen tower is unchanged, each micro step launches flash fwd and bwd
   12 times, LayerNorm-quant 13 x 4, the MLP kernel 12 x 4 and inference
   attention 12 x 4, and no plain twin; it prints examples/s (all
   examples of the micro steps after TRAIN_WARM over their wall time, the
   median step's rate beside it), peak memory, the device idle share of
   one profiled accumulation window (1 - kernel time / that window's
   wall time) and the top device operations.
Each of phases 4-9 zeroes every launch count just before it and reads
them just after: each kernel of that path must have launched, and no
plain twin may have run.

Tolerances (kernel vs plain twin on the same inputs):
  attention float32  max |diff| <= 1e-4
  attention bfloat16 |diff| <= 2**-6 + 2**-8 |ref| (one bf16 ulp: both
                     round P and the output to bf16)
  float scores       |diff| <= 1e-4 |ref| (top-k, window maxima; both
                     sides accumulate exact products in float32, in
                     another order); rescored rows, near 0 as often as
                     not, <= 1e-4 |ref| + 1e-4
  top-k ids          identical wherever the adjacent scores differ by
                     more than 1e-5 |s| (below that a summation-order
                     difference may swap two near-equal rows); window
                     rows (a1) identical where v1 - v2 > 1e-5 |v1|
  int8 x int8        exact: scores equal, ids identical at every position
  select, rescore    bit-identical to the twin's values and rows / to the
                     window kernel's own v1, v2
  LayerNorm (-quant) y within one bf16 ulp (2**-7 |ref| + 1e-5); yq, ys
                     exactly the quantization of the kernel's own y; codes
                     within 1 of the twin's at under 0.1% of positions
  flash attention    float32 out and dqkv max |diff| <= 1e-5; bfloat16
                     within one bf16 ulp of the tensor's largest magnitude
                     (both round P, dS and the outputs to bf16)
  int8 MLP block     the JAX package's bounds for its kernel
                     (tests/test_fused_mlp.py): |diff| <= 2**-6 |ref| +
                     0.07, under 0.2% past 2**-6 (1 + |ref|); yq, ys and
                     codes as for LayerNorm-quant
  int8 bf16 tower    embeddings vs the plain-twin tower: max |diff| <=
                     TOWER_ATOL = 0.25, cosine >= TOWER_MIN_COS = 0.999
                     (unit-scale rows).  Not tighter: one-ulp differences
                     (about 1e-5 of a kernel's outputs) spread through the
                     attention and the denses, and the bf16 rounding and
                     per-token codes after each of them, to ~90% of the
                     carry by layer 12; two bf16 int8 towers that round
                     differently end ~0.1 apart (cosine ~0.9996), as far
                     as either is from the f32 float tower.  So the
                     kernel tower's minimum cosine to the f32 float tower
                     must also be within TOWER_COS_SLACK = 2e-4 of the
                     plain-twin tower's (phase 7)
  train micro step   the trained tower through the kernels vs through
                     its plain twins, the same int8 frozen towers (phase
                     9a): loss within TRAIN_LOSS_RTOL = 1% and the whole
                     gradient vector within TRAIN_GRAD_REL = 5% of the
                     twin's norm: the two differ only where a bf16 ulp of
                     attention output or dqkv differs, which the bf16
                     GEMMs of 12 layers spread; a step with other dropout
                     draws must sit beyond TRAIN_GRAD_REL

The line before the last is the card's nvidia-smi name and power limit;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

N_ROWS = 2_500_000
N_PAD = 1_000  # rows past n_valid in phase 3
DIM = 768
TOP_K = 100
Q_KERNEL = 256
ATTN_B, ATTN_L = 8, 512
N_BATCHED = 128  # two full max_batch=64 dispatches
N_BATCHED_INT8 = 64
N_SINGLE = 4
N_BLOCKS = 4  # phase 6: 625,000-row blocks
WARM_POOL = 13_282 + 4 * 128  # the v4 pool of 1.7M float32 rows (sw 128)
INTER = 3072
ENC_BATCH, ENC_LEN = 256, 384  # the corpus-encode batch (phases 3 and 8)
N_CORPUS, ENC_BLOCK = 2_048, 1_024  # phase 8: 8 batches, 2 blocks
# the int8 bf16 tower against its plain-twin tower, on unit-scale outputs;
# the int8 bf16 tower's distance to the f32 float tower, against the twin's
TOWER_ATOL, TOWER_MIN_COS, TOWER_COS_SLACK = 0.25, 0.999, 2e-4
# phase 9: the JAX bench's training geometry (bench.py:162-236)
TRAIN_B, TRAIN_QLEN, TRAIN_PLEN = 64, 512, 384
TRAIN_B_CHECK = 16  # phase 9a
TRAIN_MICRO, TRAIN_ACC, TRAIN_WARM = 8, 2, 2
# random-init towers score in the tens (unit-variance 768-wide embeddings)
# and Adam's first steps move every weight by ~lr: 2e-4 overshot (the
# loss rose 3x after the first update), so the smoke steps gently
TRAIN_LR = 2e-6
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL = 0.01, 0.05
FLASH_MAIN = f"bfloat16, drop 0.1, B {TRAIN_B}"  # rows 11-12 at phase 9's shape
WORDS = [f"w{i}" for i in range(5000)]
# the card's peaks (NVIDIA H100 SXM data sheet, dense) and memory rate
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


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


def bound(flops: float, nbytes: float, peak: str):
    """(least ms, "operations" or "bytes"): the larger of the operations
    over the peak of their type and the bytes over the memory rate."""
    t_ops = flops / PEAK[peak] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_row(flops: float, nbytes: float, peak: str) -> dict:
    ms, by = bound(flops, nbytes, peak)
    return {"bound_ms": ms, "bound_by": by}


def attention_flops(lengths, L: int, H: int, matmuls: int) -> float:
    """2 x L x (valid keys) x H per batch row and L x L-sized product."""
    return 2.0 * matmuls * L * float(np.sum(lengths)) * H


PEAK_OF = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}


def search_bound(p, Q: int, n_valid: int, name: str, out_bytes: int) -> dict:
    """A score pass over the passages: 2 Q n_valid D operations in the
    passages' type, each passage row read once."""
    return bound_row(2.0 * Q * n_valid * DIM, p.numel() * p.element_size() + Q * DIM * 4
                     + out_bytes, PEAK_OF[name])


def sdpa_operands(qkv, mask, heads: int = 12):
    """q, k, v [B, heads, L, d] views of the fused projection and the
    additive padding bias, for F.scaled_dot_product_attention."""
    B, L, H3 = qkv.shape
    q, k, v = qkv.view(B, L, 3, heads, H3 // 3 // heads).permute(2, 0, 3, 1, 4)
    bias = ((1.0 - mask.to(qkv.dtype)) * -1e9)[:, None, None, :]
    return q, k, v, bias


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


def compare_exact(s, i, rs, ri, what: str) -> float:
    """int8 x int8: ids identical at every position, scores bit for bit."""
    check(torch.equal(i.cpu(), ri.cpu()), f"{what}: ids differ")
    check(torch.equal(s.cpu(), rs.cpu()), f"{what}: scores differ")
    return 0.0


def _count_modules():
    from haconvdr_torch.ops import (
        flash_attention,
        fused_attention,
        fused_ln,
        fused_mlp,
        fused_topk,
        topk_v4,
    )

    return {"fused_attention": fused_attention, "fused_topk": fused_topk, "topk_v4": topk_v4,
            "fused_ln": fused_ln, "fused_mlp": fused_mlp, "flash_attention": flash_attention}


def zero_counts():
    for mod in _count_modules().values():
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0


def read_counts():
    return {name: dict(mod.COUNTS) for name, mod in _count_modules().items()}


def check_counts(counts, need, what: str) -> None:
    """Every (module, key) in ``need`` launched; no plain twin ran."""
    for mod, key in need:
        check(counts[mod][key] > 0, f"{what}: {mod} {key} never launched")
    for mod, c in counts.items():
        for key, n in c.items():
            check(not key.startswith("plain") or n == 0, f"{what}: a plain twin of {mod} ran")


def int8_plain(q_folded, codes, n_valid):
    """Plain int8 x int8 scoring: the per-query codes of the folded
    queries, exact integer scores, dequantized once."""
    from haconvdr_torch.index.quantize import quantize_queries_int8
    from haconvdr_torch.ops.fused_topk import fused_topk_block_plain

    q8, q_scale = quantize_queries_int8(q_folded)
    s, i = fused_topk_block_plain(q8, codes, n_valid, TOP_K)
    return s * (q_scale[:, None] / 127.0), i


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain twin
# ---------------------------------------------------------------------------

def kernels_v3_attention(dev, g, rng, passages_f32, codes, scale, rows):
    from haconvdr_torch.ops.fused_attention import (
        fused_attention_qkv,
        fused_attention_qkv_plain,
    )
    from haconvdr_torch.ops.fused_topk import fused_topk_block, fused_topk_block_plain

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
        q, k, v, bias = sdpa_operands(qkv, mask)
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias), reps=10)
        isz = qkv.element_size()
        rows.append(dict(kernel="fused_attention", config=name, max_abs_err=float(diff.max()),
                         ms=ms, plain_ms=pms, library_ms=lms, shape=[ATTN_B, ATTN_L, 3 * DIM],
                         **bound_row(attention_flops(lengths, ATTN_L, DIM, 2),
                                     ATTN_B * ATTN_L * (4 * DIM * isz + 4),
                                     "f32" if dt == torch.float32 else "bf16")))
        del qkv, out, ref, q, k, v, bias
    # -- v3 top-k: f32, bf16, and the int8 mode (folded float queries)
    q = torch.randn(Q_KERNEL, DIM, device=dev, generator=g)
    extra = torch.randn(100_000, DIM, device=dev, generator=g)
    n_valid = N_ROWS - N_PAD
    q_fold = q * scale
    for name in ("float32", "bfloat16", "int8"):
        p = {"float32": passages_f32, "bfloat16": None, "int8": codes}[name]
        if p is None:
            p = passages_f32.to(torch.bfloat16)
        qq = q_fold if name == "int8" else q
        # a running best from other rows: q_fold . codes approximates q . p
        seed_scores = torch.topk(q @ extra.T, TOP_K, dim=1).values.contiguous()
        for seeded in (False, True):
            init = seed_scores if seeded else None
            s, i = fused_topk_block(qq, p, n_valid, TOP_K, init_scores=init)
            torch.cuda.synchronize()
            rs, ri = fused_topk_block_plain(qq, p, n_valid, TOP_K, init_scores=init)
            tag = f"top-k {name}{' seeded' if seeded else ''}"
            err = compare_topk(s, i, rs, ri, tag)
            check(int(i.max()) < n_valid, f"{tag}: a row past n_valid surfaced")
            if seeded:
                check(bool((i == -1).any()), f"{tag}: no seed survivor")
            ms = cuda_ms(lambda: fused_topk_block(qq, p, n_valid, TOP_K, init_scores=init), 3)
            pms = cuda_ms(
                lambda: fused_topk_block_plain(qq, p, n_valid, TOP_K, init_scores=init), 3
            )
            rows.append(dict(kernel="fused_topk", config=tag[6:], max_abs_err=err, ms=ms,
                             plain_ms=pms, library_ms=None, shape=[Q_KERNEL, N_ROWS, DIM, TOP_K],
                             **search_bound(p, Q_KERNEL, n_valid, name, Q_KERNEL * TOP_K * 8)))
        del p
    del extra
    torch.cuda.empty_cache()


def v4_operands(dev, g, passages_f32, codes, scale):
    """Per dtype: (queries in the kernels' dtype, passages, folded float
    queries for topk_block_v4)."""
    from haconvdr_torch.index.quantize import quantize_queries_int8

    q = torch.randn(Q_KERNEL, DIM, device=dev, generator=g)
    q_fold = q * scale
    yield "float32", q, passages_f32, q
    bf = passages_f32.to(torch.bfloat16)
    yield "bfloat16", q.to(torch.bfloat16), bf, q
    del bf
    torch.cuda.empty_cache()
    yield "int8", quantize_queries_int8(q_fold)[0], codes, q_fold


def kernels_v4(dev, g, passages_f32, codes, scale, rows):
    from haconvdr_torch.ops import topk_v4 as v4
    from haconvdr_torch.ops.fused_topk import fused_topk_block_plain

    n_valid = N_ROWS - N_PAD
    sw, _ = v4.resolve_select_geometry(N_ROWS, torch.float32)
    shape = [Q_KERNEL, N_ROWS, DIM, TOP_K]
    panels = None
    for name, q, p, qf in v4_operands(dev, g, passages_f32, codes, scale):
        exact = name == "int8"
        budget = v4.resolve_select_geometry(N_ROWS, p.dtype)[1]
        # -- window top-2
        v1, a1, v2 = v4.window_top2(q, p, n_valid, sw)
        torch.cuda.synchronize()
        r1, ra, r2 = v4.window_top2_plain(q, p, n_valid, sw)
        err = 0.0
        for got, ref, what in ((v1, r1, "v1"), (v2, r2, "v2")):
            fin = torch.isfinite(ref)
            check(torch.equal(fin, torch.isfinite(got)), f"window {name}: {what} -inf differs")
            d = (got[fin] - ref[fin]).abs()
            check(bool((d <= (0.0 if exact else 1e-4) * ref[fin].abs()).all()),
                  f"window {name}: {what} beyond tolerance ({float(d.max())})")
            err = max(err, float(d.max()))
        gap = torch.isfinite(r1) & ((r1 - r2) > (0.0 if exact else 1e-5) * r1.abs())
        check(torch.equal(a1[gap], ra[gap]), f"window {name}: a1 differs at separated v1/v2")
        rows.append(dict(kernel="window_top2", config=name, max_abs_err=err,
                         ms=cuda_ms(lambda: v4.window_top2(q, p, n_valid, sw), 3),
                         plain_ms=cuda_ms(lambda: v4.window_top2_plain(q, p, n_valid, sw), 3),
                         library_ms=None, shape=[Q_KERNEL, N_ROWS, DIM, sw],
                         **search_bound(p, Q_KERNEL, n_valid, name, 3 * v1.numel() * 4)))
        # -- rescore: budget 8 random windows, bit for bit against the window kernel
        W = v1.shape[0]
        win = torch.randint(0, W, (Q_KERNEL, 8), device=dev, generator=g, dtype=torch.int32)
        win[:, -1] = -1  # an empty slot
        resc = v4.rescore_windows(p, q, win, sw, n_valid)
        torch.cuda.synchronize()
        ref = v4.rescore_windows_plain(p, q, win, sw, n_valid)
        fin = torch.isfinite(ref)
        check(torch.equal(fin, torch.isfinite(resc)), f"rescore {name}: -inf differs")
        d = (resc[fin] - ref[fin]).abs()
        check(bool((d <= (0.0 if exact else 1e-4) * ref[fin].abs() + (0 if exact else 1e-4)).all()),
              f"rescore {name}: beyond tolerance ({float(d.max())})")
        r3 = resc.view(Q_KERNEL, 8, sw)[:, :7]
        qi = torch.arange(Q_KERNEL, device=dev)[:, None].expand(-1, 7)
        w = win[:, :7].long()
        check(torch.equal(r3.amax(2), v1[w, qi]), f"rescore {name}: max != window v1")
        pos = a1[w, qi].long() - w * sw
        check(torch.equal(r3.scatter(2, pos[..., None], float("-inf")).amax(2), v2[w, qi]),
              f"rescore {name}: second max != window v2")
        check(bool(torch.isneginf(resc.view(Q_KERNEL, 8, sw)[:, -1]).all()),
              f"rescore {name}: empty slot not -inf")
        # the distinct windows this run's queries name, each read once
        n_win = int(torch.unique(win[win >= 0]).numel())
        rows.append(dict(kernel="rescore_windows", config=name, max_abs_err=float(d.max()),
                         ms=cuda_ms(lambda: v4.rescore_windows(p, q, win, sw, n_valid), 3),
                         plain_ms=cuda_ms(
                             lambda: v4.rescore_windows_plain(p, q, win, sw, n_valid), 3),
                         library_ms=None, shape=[Q_KERNEL, 8, sw, DIM],
                         **bound_row(2.0 * Q_KERNEL * 7 * sw * DIM,
                                     n_win * sw * DIM * p.element_size() + q.numel()
                                     * q.element_size() + win.numel() * 4 + resc.numel() * 4,
                                     PEAK_OF[name])))
        if name == "float32":  # select panels from real window scores
            panels = {
                # the path's pool [W + 8 sw, Q]: 93 segments of 128 rows,
                # fewer than k, so the path's selects run cold
                "cold": torch.cat([v1, r2[: 8 * sw]]).contiguous(),
                # the pool of a 1.7M-row float32 search (sw 128, budget 4):
                # [13,282 + 4 * 128, Q], 108 segments, so a floor applies
                "warm": torch.cat([v1, r2[: WARM_POOL - W]]).contiguous(),
            }
        del v1, a1, v2, r1, ra, r2, resc, ref
        # -- the whole v4 search against the plain exact top-k
        s, i = v4.topk_block_v4(qf, p, n_valid, TOP_K)
        torch.cuda.synchronize()
        if exact:
            rs, ri = int8_plain(qf, p, n_valid)
            err = compare_exact(s, i, rs, ri, "v4 int8")
        else:
            rs, ri = fused_topk_block_plain(qf, p, n_valid, TOP_K)
            err = compare_topk(s, i, rs, ri, f"v4 {name}")
        check(int(i.max()) < n_valid, f"v4 {name}: a row past n_valid surfaced")
        rows.append(dict(kernel="topk_block_v4", config=name, max_abs_err=err,
                         ms=cuda_ms(lambda: v4.topk_block_v4(qf, p, n_valid, TOP_K), 3),
                         plain_ms=cuda_ms(
                             lambda: fused_topk_block_plain(qf, p, n_valid, TOP_K), 3),
                         shape=shape + [budget]))
        if name == "bfloat16":  # -- forced fallback: one row planted 4096 times
            saved = p[:4096].clone()
            p[:4096] = p[:1] * 4
            before = v4.COUNTS["v3_fallback"]
            s, i = v4.topk_block_v4(qf, p, n_valid, TOP_K)
            torch.cuda.synchronize()
            check(v4.COUNTS["v3_fallback"] == before + 1, "forced fallback did not fall back")
            rs, ri = fused_topk_block_plain(qf, p, n_valid, TOP_K)
            compare_topk(s, i, rs, ri, "v4 forced fallback")
            print(f"v4 forced fallback: v3_fallback {before} -> {v4.COUNTS['v3_fallback']}, exact")
            p[:4096] = saved
    # -- select: both layouts, cold at the path's pool, warm (with a floor)
    # at a pool wide enough for warm_floor; a floor must change no answer
    k = TOP_K
    for temp, panel in panels.items():
        fl = v4.warm_floor(panel, k) if temp == "warm" else None
        if temp == "warm":
            check(fl is not None, "warm select: warm_floor gave no floor")
            admitted = float((panel > fl[None, :]).sum(0).double().mean())
            print(f"warm select: the floor admits {admitted:.1f} of {panel.shape[0]} "
                  "entries per query")
        ids = torch.randperm(panel.shape[0], device=dev, generator=g).to(torch.int32)
        ids_t = ids[:, None].expand(-1, Q_KERNEL).contiguous()
        rowmajor, rowmajor_ids = panel.T.contiguous(), ids_t.T.contiguous()
        cases = (  # (name, kernel(floor), plain twin(floor), library call, id bytes)
            ("select_topk_t", lambda f: v4.select_topk_t(panel, k, floor=f),
             lambda f: v4.select_plain(panel.T, k, f), lambda: torch.topk(panel, k, dim=0), 0),
            ("select_topk", lambda f: v4.select_topk(rowmajor, k, floor=f, ids=rowmajor_ids),
             lambda f: v4.select_plain(rowmajor, k, f, rowmajor_ids),
             lambda: torch.topk(rowmajor, k, dim=1), rowmajor_ids.numel() * 4),
        )
        for kname, run, plain, library, id_bytes in cases:
            got, ref, ref_cold = run(fl), plain(fl), plain(None)
            torch.cuda.synchronize()
            for want, what in ((ref, "the plain twin"), (ref_cold, "the cold plain twin")):
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"{kname} {temp}: differs from {what}")
            # a selection reads each score once: bytes-bound
            row = dict(kernel=kname, config=temp, max_abs_err=0.0,
                       ms=cuda_ms(lambda: run(fl), 5), plain_ms=cuda_ms(lambda: plain(fl), 5),
                       library_ms=cuda_ms(library, 5), shape=list(panel.shape) + [k],
                       **bound_row(panel.numel(), panel.numel() * 4 + id_bytes
                                   + Q_KERNEL * k * 8, "f32"))
            if temp == "warm":  # the same panel without the floor
                row["cold_ms"] = cuda_ms(lambda: run(None), 5)
            rows.append(row)
    torch.cuda.empty_cache()


def int8_weight(g, dev, out_dim, in_dim):
    """[out, in] int8 codes and per-output-channel kernel_scale of a
    normal(0, 0.02) kernel, as quantize_encoder_params makes them."""
    w = torch.randn(out_dim, in_dim, device=dev, generator=g) * 0.02
    s = w.abs().amax(dim=1)
    return torch.clamp(torch.round(w / s[:, None] * 127.0), -127, 127).to(torch.int8), s / 127.0


def codes_close(q, rq, what: str) -> float:
    """int8 codes within 1 of the twin's at under 0.1% of positions;
    returns the share that differ."""
    dq = (q.int() - rq.int()).abs()
    frac = float((dq > 0).float().mean())
    check(int(dq.max()) <= 1 and frac < 1e-3,
          f"{what}: codes differ from the twin's by up to {int(dq.max())} at {frac:.2e}")
    return frac


def kernels_int8_tower(dev, g, rows):
    """Rows 8-10 at the corpus-encode batch: [256 x 384, 768] rows, I 3072."""
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.ops import fused_ln as fl
    from haconvdr_torch.ops import fused_mlp as fm

    R = ENC_BATCH * ENC_LEN
    x32 = torch.randn(R, DIM, device=dev, generator=g) * 3.0  # embedding sums: float32
    xb = x32.to(torch.bfloat16)
    r = torch.randn(R, DIM, device=dev, generator=g).to(torch.bfloat16)
    lns = torch.randn(DIM, device=dev, generator=g) * 0.5 + 1.0
    lnb = torch.randn(DIM, device=dev, generator=g) * 0.1
    eps, bf = 1e-5, torch.bfloat16
    lns_b, lnb_b = lns.to(bf), lnb.to(bf)
    ln_library = lambda: F.layer_norm(xb, (DIM,), lns_b, lnb_b, eps)  # noqa: E731
    cases = (  # (kernel, config, kernel call, plain-twin call, library call, bytes)
        ("fused_ln", "bf16 + residual",
         lambda: fl.fused_residual_ln(xb, r, lns, lnb, eps),
         lambda: fl.fused_residual_ln_plain(xb, r, lns, lnb, eps), None, R * DIM * 6),
        ("fused_ln", "bf16, no residual",
         lambda: fl.fused_residual_ln(xb, None, lns, lnb, eps),
         lambda: fl.fused_residual_ln_plain(xb, None, lns, lnb, eps), ln_library, R * DIM * 4),
        ("fused_ln_quant", "bf16 + residual",
         lambda: fl.fused_residual_ln_quant(xb, r, lns, lnb, eps),
         lambda: fl.fused_residual_ln_quant_plain(xb, r, lns, lnb, eps), None,
         R * DIM * 7 + R * 4),
        ("fused_ln_quant", "f32, no residual",
         lambda: fl.fused_residual_ln_quant(x32, None, lns, lnb, eps, bf),
         lambda: fl.fused_residual_ln_quant_plain(x32, None, lns, lnb, eps, bf), None,
         R * DIM * 7 + R * 4),
    )
    for name, config, run, plain, library, nbytes in cases:
        got, ref = run(), plain()
        torch.cuda.synchronize()
        quant = name == "fused_ln_quant"
        y, ry = (got[0], ref[0]) if quant else (got, ref)
        d = (y.float() - ry.float()).abs()
        check(y.dtype == bf and bool((d <= 2.0**-7 * ry.float().abs() + 1e-5).all()),
              f"{name} {config}: y beyond one bf16 ulp ({float(d.max())})")
        row = dict(kernel=name, config=config, max_abs_err=float(d.max()),
                   y_diff_share=float((d > 0).float().mean()),
                   ms=cuda_ms(run, 5), plain_ms=cuda_ms(plain, 5),
                   library_ms=cuda_ms(library, 5) if library else None, shape=[R, DIM],
                   **bound_row(10.0 * R * DIM, nbytes + 2 * DIM * 4, "f32"))
        if quant:
            oq, os_ = quantize_rows(y)
            check(torch.equal(got[1], oq) and torch.equal(got[2], os_),
                  f"{name} {config}: yq, ys are not the quantization of the kernel's y")
            row["code_diff_share"] = codes_close(got[1], ref[1], f"{name} {config}")
        rows.append(row)
        del got, ref, y, ry, d
    # -- the MLP block on an LN output carry
    x = fl.fused_residual_ln_plain(xb, r, lns, lnb, eps)
    del x32, xb, r
    xq, xs = quantize_rows(x)
    w1, s1 = int8_weight(g, dev, INTER, DIM)
    w2, s2 = int8_weight(g, dev, DIM, INTER)
    b1 = torch.randn(INTER, device=dev, generator=g) * 0.02
    b2 = torch.randn(DIM, device=dev, generator=g) * 0.02
    args = (x, xq, xs, w1, s1, b1, w2, s2, b2, lns, lnb)
    run = lambda: fm.fused_mlp_block(*args, eps=eps)  # noqa: E731
    plain = lambda: fm.fused_mlp_block_plain(*args, eps=eps)  # noqa: E731
    (y, yq, ys), (ry, rq, _) = run(), plain()
    torch.cuda.synchronize()
    gy, wy = y.float(), ry.float()
    d = (gy - wy).abs()
    flips = float((d > 2.0**-6 * (1 + wy.abs())).float().mean())
    check(bool((d <= 2.0**-6 * wy.abs() + 0.07).all()) and flips < 2e-3,
          f"fused_mlp: beyond the JAX test's bounds (max {float(d.max())}, flips {flips})")
    oq, os_ = quantize_rows(y)
    check(torch.equal(yq, oq) and torch.equal(ys, os_),
          "fused_mlp: yq, ys are not the quantization of the kernel's y")
    rows.append(dict(kernel="fused_mlp", config="bf16", max_abs_err=float(d.max()),
                     y_diff_share=float((d > 0).float().mean()), flip_share=flips,
                     code_diff_share=codes_close(yq, rq, "fused_mlp"),
                     ms=cuda_ms(run, 3), plain_ms=cuda_ms(plain, 3), library_ms=None,
                     shape=[R, DIM, INTER],
                     **bound_row(4.0 * R * DIM * INTER, R * DIM * 6 + R * 8
                                 + 2 * DIM * INTER * 1, "int8")))
    del args, x, xq, xs, y, yq, ys, ry, rq, gy, wy, d
    torch.cuda.empty_cache()


def bf16_ulp_of_max(ref: torch.Tensor) -> float:
    return float(2.0 ** (np.floor(np.log2(float(ref.float().abs().max()))) - 7))


def kernels_flash(dev, g, rng, rows):
    """Rows 11-12: the trained tower's attention forward and backward at
    B 8, L 512, H 768, 12 heads (float32 and bfloat16, dropout 0 and 0.1),
    and at phase 9's own shape (B 64, query lengths 64-512, bfloat16,
    dropout 0.1), against the plain twins on the same qkv, mask, output
    cotangent and seed words."""
    from haconvdr_torch.ops import flash_attention as fa

    def ragged_mask(B, lo):
        lengths = rng.integers(lo, ATTN_L + 1, B)
        lengths[0] = ATTN_L
        return lengths, torch.from_numpy(
            (np.arange(ATTN_L)[None, :] < lengths[:, None]).astype(np.int32)).to(dev)

    small = ragged_mask(ATTN_B, 1)
    seed = fa.draw_seed(torch.Generator().manual_seed(int(rng.integers(1 << 30))))
    cases = [(small, dt, rate, f"{name}, drop {rate}")
             for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"))
             for rate in (0.0, 0.1)]
    cases.append((ragged_mask(TRAIN_B, TRAIN_QLEN // 8), torch.bfloat16, 0.1, FLASH_MAIN))
    for (lengths, mask), dt, rate, config in cases:
        B = len(lengths)
        name = "float32" if dt == torch.float32 else "bfloat16"
        qkv = (torch.randn(B, ATTN_L, 3 * DIM, device=dev, generator=g) * 0.5).to(dt)
        go = torch.randn(B, ATTN_L, DIM, device=dev, generator=g).to(dt)
        x = qkv.clone().requires_grad_(True)
        out = fa.flash_attention(x, mask, 12, seed=seed, drop_rate=rate)
        out.backward(go)
        torch.cuda.synchronize()
        ref = fa.flash_attention_fwd_plain(qkv, mask, 12, seed, rate)
        rdq = fa.flash_attention_bwd_plain(qkv, mask, go, 12, seed, rate)
        errs = []
        for got, want, what in ((out.detach(), ref, "forward"), (x.grad, rdq, "dqkv")):
            err = float((got.float() - want.float()).abs().max())
            tol = 1e-5 if dt == torch.float32 else bf16_ulp_of_max(want)
            check(err <= tol, f"flash {what} {config}: {err} > {tol}")
            errs.append(err)
        m32 = mask.contiguous()
        with torch.no_grad():
            _, stats = fa._fwd_kernel(qkv, m32, 12, seed, rate)
            fwd_ms = cuda_ms(lambda: fa._fwd_kernel(qkv, m32, 12, seed, rate), 10)
            bwd_ms = cuda_ms(lambda: fa._bwd_kernel(qkv, m32, stats, go, 12, seed, rate), 10)
            pf_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(qkv, mask, 12, seed, rate), 5)
            pb_ms = cuda_ms(
                lambda: fa.flash_attention_bwd_plain(qkv, mask, go, 12, seed, rate), 5)
            q, k, v, bias = sdpa_operands(qkv, mask)
            lf_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, dropout_p=rate), 10)
        xl = qkv.clone().requires_grad_(True)
        ql, kl, vl, _ = sdpa_operands(xl, mask)
        gh = go.view(B, ATTN_L, 12, 64).transpose(1, 2)
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, dropout_p=rate)
        lb_ms = cuda_ms(lambda: torch.autograd.grad(ol, xl, gh, retain_graph=True), 10)

        def library_fwd_bwd():
            F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, dropout_p=rate
                                           ).backward(gh)

        lfb_ms = cuda_ms(library_fwd_bwd, 10)
        isz, peak = qkv.element_size(), PEAK_OF[name]
        shape = [B, ATTN_L, 3 * DIM]
        rows.append(dict(kernel="flash_attention_fwd", config=config, max_abs_err=errs[0],
                         ms=fwd_ms, plain_ms=pf_ms, library_ms=lf_ms, shape=shape,
                         **bound_row(attention_flops(lengths, ATTN_L, DIM, 2),
                                     B * ATTN_L * (4 * DIM * isz + 4), peak)))
        # the backward recomputes S (one L x L product) and forms dV,
        # dP, dQ and dK; its library figure is SDPA's backward alone (to
        # dqkv, through the same views), with SDPA forward + backward beside
        rows.append(dict(kernel="flash_attention_bwd", config=config, max_abs_err=errs[1],
                         ms=bwd_ms, plain_ms=pb_ms, library_ms=lb_ms,
                         fwd_plus_bwd_ms=fwd_ms + bwd_ms, library_fwd_bwd_ms=lfb_ms,
                         shape=shape,
                         **bound_row(attention_flops(lengths, ATTN_L, DIM, 5),
                                     B * ATTN_L * (7 * DIM * isz + 4), peak)))
        del qkv, go, x, out, ref, rdq, stats, q, k, v, bias, xl, ql, kl, vl, gh, ol
    torch.cuda.empty_cache()


def phase_kernels(seed: int, dev, passages_f32, codes, scale):
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)
    rows = []
    kernels_v3_attention(dev, g, rng, passages_f32, codes, scale, rows)
    kernels_v4(dev, g, passages_f32, codes, scale, rows)
    kernels_int8_tower(dev, g, rows)
    kernels_flash(dev, g, rng, rows)
    return rows


# ---------------------------------------------------------------------------
# phases 4-6: the paths
# ---------------------------------------------------------------------------

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


def serve(retriever, batched_reqs, single_reqs):
    """Warm-up, concurrent requests through BatchingRetriever(max_batch=64),
    then single Retriever.retrieve calls: (answers, metrics)."""
    from haconvdr_torch.serve import BatchingRetriever

    retriever.retrieve(*single_reqs[0])
    n = len(batched_reqs)
    answers = [None] * n
    latency = [0.0] * n
    with BatchingRetriever(retriever, max_batch=64, max_wait_ms=50.0) as batcher:

        def client(idx):
            t = time.perf_counter()
            answers[idx] = batcher.submit(*batched_reqs[idx]).result(timeout=600)
            latency[idx] = time.perf_counter() - t

        threads = [threading.Thread(target=client, args=(j,)) for j in range(n)]
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
    metrics = dict(batched_qps=n / wall, batched_p50_ms=float(np.median(latency)) * 1e3,
                   batched_max_ms=max(latency) * 1e3, dispatches=stats["dispatches"],
                   batch_histogram=stats["batch_histogram"],
                   single_ms=[x * 1e3 for x in single_lat])
    return answers + singles, metrics


def build_retriever(params, cfg, dev, store, offset2pid, store_dtype="float32",
                    encoder_int8=False):
    from haconvdr_torch.config import DataConfig, SearchConfig
    from haconvdr_torch.serve import Retriever
    from haconvdr_torch.utils.testing import HashTokenizer

    return Retriever(
        HashTokenizer(cfg.vocab_size), params, cfg, store,
        offset2pid=offset2pid,
        data_cfg=DataConfig(is_train=False, use_PRL=False),  # max_concat_length 512
        search_cfg=SearchConfig(top_k=TOP_K, per_device_test_batch_size=64),
        device=dev, store_dtype=store_dtype, encoder_int8=encoder_int8,
    )


def phase_main_path(seed: int, dev, passages_f32, params, cfg, card: str):
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.ops import fused_topk
    from haconvdr_torch.parallel.sharded_encode import batch_iter, encode_batches

    t0 = time.perf_counter()
    offset2pid = np.arange(N_ROWS, dtype=np.int64) * 7 + 11
    retriever = build_retriever(params, cfg, dev, passages_f32, offset2pid)
    print(f"main path: set up in {time.perf_counter() - t0:.1f} s "
          f"(params {cfg.num_hidden_layers}x{cfg.hidden_size}, index {N_ROWS}x{DIM} f32, "
          f"kernel {retriever.index.kernel})")
    reqs = make_requests(seed, N_BATCHED + N_SINGLE)
    zero_counts()
    got, metrics = serve(retriever, reqs[:N_BATCHED], reqs[N_BATCHED:])
    counts = read_counts()
    print("main path launch counts:", json.dumps(counts))
    check_counts(counts, [("fused_attention", "kernel"), ("topk_v4", "window"),
                          ("topk_v4", "select_t"), ("topk_v4", "select")], "main path")
    print(f"main path: rescore launches {counts['topk_v4']['rescore']}, "
          f"v3_fallback {counts['topk_v4']['v3_fallback']}")
    print("main path e2e:", json.dumps(metrics), f"[{card}]")

    # ---- plain-twin reference for the same queries, on the card
    ref_enc = AnceEncoder.from_jax_params(params, cfg, dev, plain=True)
    examples = [retriever.build_query(*r) for r in reqs]
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
    for j, ans in enumerate(got):
        check(ans is not None and len(ans) == TOP_K, f"request {j}: {len(ans or [])} hits")
        s = torch.tensor([[x[1] for x in ans]])
        i = torch.tensor([[x[0] for x in ans]])
        compare_topk(s, i, rs[j : j + 1].cpu(), ri_pid[j : j + 1], f"request {j}")
    print(f"main path answers match the plain twins for {len(got)} requests "
          f"(query embedding max |diff| {emb_err:.3g})")
    del retriever, ref_enc
    torch.cuda.empty_cache()
    return counts, metrics, got_q


def phase_int8_path(seed: int, dev, passages_f32, params, cfg, card: str):
    t0 = time.perf_counter()
    retriever = build_retriever(params, cfg, dev, passages_f32, None, store_dtype="int8")
    index = retriever.index
    print(f"int8 path: set up in {time.perf_counter() - t0:.1f} s (index {N_ROWS}x{DIM} int8, "
          f"{index.passages.numel() / 2**30:.2f} GiB quantized on the card)")
    calls = []  # (query embeddings, answer) of every index search
    search = index.search

    def recording_search(queries, k):
        out = search(queries, k)
        calls.append((np.array(queries, copy=True), out))
        return out

    index.search = recording_search
    reqs = make_requests(seed + 10, N_BATCHED_INT8 + N_SINGLE)
    zero_counts()
    got, metrics = serve(retriever, reqs[:N_BATCHED_INT8], reqs[N_BATCHED_INT8:])
    counts = read_counts()
    print("int8 path launch counts:", json.dumps(counts))
    check_counts(counts, [("fused_attention", "kernel"), ("topk_v4", "window"),
                          ("topk_v4", "select_t"), ("topk_v4", "select"),
                          ("topk_v4", "rescore")], "int8 path")
    print("int8 path e2e:", json.dumps(metrics), f"[{card}]")
    check(all(a is not None and len(a) == TOP_K for a in got), "int8 path: short answers")
    n_q = 0
    for q, (s, i) in calls:
        qt = torch.from_numpy(q).to(dev)
        rs, ri = int8_plain(qt.to(torch.float32) * index.scale, index.passages, N_ROWS)
        compare_exact(torch.from_numpy(s), torch.from_numpy(i), rs, ri, "int8 path search")
        n_q += q.shape[0]
    print(f"int8 path: {len(calls)} searches ({n_q} query rows) equal the plain int8 "
          "scoring: ids at every position, scores bit for bit")
    scale = index.scale
    del retriever, index, calls
    torch.cuda.empty_cache()
    return counts, metrics, scale


def phase_streaming(dev, passages_f32, scale, queries):
    from haconvdr_torch.index.quantize import encode_int8_torch
    from haconvdr_torch.ops.fused_topk import fused_topk_block_plain
    from haconvdr_torch.ops.topk import BlockSearcher

    per = N_ROWS // N_BLOCKS
    gid = torch.arange(N_ROWS, device=dev, dtype=torch.int32) * 7 + 11
    blocks = [(passages_f32[b * per : (b + 1) * per], gid[b * per : (b + 1) * per])
              for b in range(N_BLOCKS)]
    q = torch.from_numpy(queries).to(dev)
    runs = {}
    zero_counts()
    t0 = time.perf_counter()
    for name, kw in (
        ("per-block", {}),
        ("superblock f32", dict(superblock_rows=N_ROWS)),
        ("superblock int8", dict(superblock_rows=N_ROWS, superblock_dtype="int8",
                                 superblock_scale=scale)),
    ):
        t = time.perf_counter()
        runs[name] = BlockSearcher(top_k=TOP_K, device=dev, **kw).search(
            q, blocks, return_device=True
        )
        torch.cuda.synchronize()
        runs[name] = runs[name] + (time.perf_counter() - t,)
    counts = read_counts()
    print("streaming path launch counts:", json.dumps(counts))
    check_counts(counts, [("fused_topk", "kernel"), ("topk_v4", "window"),
                          ("topk_v4", "select_t"), ("topk_v4", "select")], "streaming path")
    print(f"streaming path: {time.perf_counter() - t0:.2f} s for three passes, "
          + ", ".join(f"{k} {v[2] * 1e3:.1f} ms" for k, v in runs.items()))
    rs, ri = fused_topk_block_plain(q, passages_f32, N_ROWS, TOP_K)
    rpid = torch.where(ri >= 0, gid[ri.clamp(min=0).long()], -1)
    for name in ("per-block", "superblock f32"):
        s, i, _ = runs[name]
        compare_topk(s, i, rs, rpid, f"streaming {name}")
    codes = encode_int8_torch(passages_f32, 1.0 / scale)  # the accumulator's codes
    rs8, ri8 = int8_plain(q.to(torch.float32) * scale, codes, N_ROWS)
    s, i, _ = runs["superblock int8"]
    compare_exact(s, i, rs8, torch.where(ri8 >= 0, gid[ri8.clamp(min=0).long()], -1),
                  "streaming superblock int8")
    print(f"streaming path answers match the plain twins ({q.shape[0]} queries; int8 "
          "accumulator exact)")
    del codes, blocks
    torch.cuda.empty_cache()
    return counts


def count_forwards(encoder):
    """Wrap encoder.forward; returns a one-element list counting its calls."""
    n = [0]
    forward = encoder.forward

    def counted(*a, **kw):
        n[0] += 1
        return forward(*a, **kw)

    encoder.forward = counted
    return n


def check_tower_counts(counts, n_fwd: int, layers: int, what: str) -> None:
    """Per forward of the int8 bf16 tower, 1 + layers LayerNorm-quant
    launches (embeddings, then each attention residual) and one MLP launch
    per layer: 13 and 12 at 12 layers."""
    check(n_fwd > 0, f"{what}: no tower forward ran")
    check(counts["fused_ln"]["ln_quant"] == (1 + layers) * n_fwd
          and counts["fused_ln"]["ln"] == 0 and counts["fused_mlp"]["kernel"] == layers * n_fwd,
          f"{what}: {n_fwd} forwards launched LN-quant {counts['fused_ln']['ln_quant']} "
          f"and MLP {counts['fused_mlp']['kernel']} times, not {1 + layers} and {layers} each")


def tower_agreement(got, ref, what: str):
    """(max |diff|, min cosine) of two [n, E] embedding sets, held to
    TOWER_ATOL and TOWER_MIN_COS."""
    check(np.isfinite(got).all() and got.shape == ref.shape, f"{what}: not finite or misshapen")
    err = float(np.abs(got - ref).max())
    cos = float(((got * ref).sum(1) / np.linalg.norm(got, axis=1)
                 / np.linalg.norm(ref, axis=1)).min())
    check(err <= TOWER_ATOL and cos >= TOWER_MIN_COS,
          f"{what}: kernel vs plain-twin tower max |diff| {err}, min cosine {cos}")
    return err, cos


def phase_int8_tower(seed: int, dev, passages_f32, params, cfg, card: str):
    """Phase 7: Retriever(encoder_int8=True) with a bfloat16 carry over the
    f32 resident index: 64 concurrent requests and a few single ones."""
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params
    from haconvdr_torch.ops.fused_topk import fused_topk_block_plain
    from haconvdr_torch.parallel.sharded_encode import batch_iter, encode_batches

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    t0 = time.perf_counter()
    retriever = build_retriever(params, cfg, dev, passages_f32, None, encoder_int8=True)
    check(retriever.encoder.int8, "int8 tower: the encoder holds no int8 kernels")
    print(f"int8 tower: set up in {time.perf_counter() - t0:.1f} s ({cfg.num_hidden_layers} x "
          f"{cfg.hidden_size} int8 dense kernels, bf16 carry; index {N_ROWS}x{DIM} f32)")
    n_fwd = count_forwards(retriever.encoder)
    index = retriever.index
    calls = []  # (query embeddings, answer) of every index search
    search = index.search

    def recording_search(queries, k):
        out = search(queries, k)
        calls.append((np.array(queries, copy=True), out))
        return out

    index.search = recording_search
    reqs = make_requests(seed + 20, N_BATCHED_INT8 + N_SINGLE)
    zero_counts()
    n_fwd[0] = 0
    got, metrics = serve(retriever, reqs[:N_BATCHED_INT8], reqs[N_BATCHED_INT8:])
    counts = read_counts()
    print("int8 tower launch counts:", json.dumps(counts), f"({n_fwd[0]} forwards)")
    check_counts(counts, [("fused_attention", "kernel"), ("fused_ln", "ln_quant"),
                          ("fused_mlp", "kernel"), ("topk_v4", "window"),
                          ("topk_v4", "select_t"), ("topk_v4", "select")], "int8 tower")
    check_tower_counts(counts, n_fwd[0], cfg.num_hidden_layers, "int8 tower")
    print("int8 tower e2e:", json.dumps(metrics), f"[{card}]")
    check(all(a is not None and len(a) == TOP_K for a in got), "int8 tower: short answers")
    n_q = 0
    for q, (s, i) in calls:
        rs, ri = fused_topk_block_plain(torch.from_numpy(q).to(dev), passages_f32, N_ROWS, TOP_K)
        compare_topk(torch.from_numpy(s), torch.from_numpy(i), rs.cpu(), ri.cpu(),
                     "int8 tower search")
        n_q += q.shape[0]
    # ---- the plain-twin tower on the same batches
    ref_enc = AnceEncoder.from_jax_params(quantize_encoder_params(params), cfg, dev, plain=True)
    examples = [retriever.build_query(*r) for r in reqs]
    ref_q, _ = encode_batches(ref_enc, batch_iter(examples, 64), "conv_qp", "conv_qp_mask")
    got_q = retriever.embed(examples)  # per_device_test_batch_size 64
    err, cos = tower_agreement(got_q, ref_q, "int8 tower query embeddings")
    f32_enc = AnceEncoder.from_jax_params(params, dataclasses.replace(cfg, dtype="float32"), dev)
    f32_q, _ = encode_batches(f32_enc, batch_iter(examples, 64), "conv_qp", "conv_qp_mask")

    def min_cos(a, b):
        return float(((a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)).min())

    cos_k, cos_p = min_cos(got_q, f32_q), min_cos(ref_q, f32_q)
    check(cos_k >= cos_p - TOWER_COS_SLACK,
          f"int8 tower: min cosine to the f32 float tower {cos_k} (kernels) vs {cos_p} (twins)")
    print(f"int8 tower: {len(calls)} searches ({n_q} query rows) match the plain search of "
          f"the same embeddings; embeddings vs the plain-twin tower max |diff| {err:.3g}, "
          f"min cosine {cos:.7f}; min cosine to the f32 float tower {cos_k:.7f} (kernels), "
          f"{cos_p:.7f} (twins)")
    del retriever, index, ref_enc, f32_enc, calls
    torch.cuda.empty_cache()
    return counts, metrics, dict(max_abs_err=err, min_cos=cos, f32_cos=cos_k, f32_cos_plain=cos_p)


def phase_corpus_encode(seed: int, dev, params, cfg, card: str):
    """Phase 8: encode_corpus through the int8 bf16 tower into int8 blocks."""
    import tempfile

    from haconvdr_torch.index.build import (
        EmbeddingBlockStore,
        TokenizedCorpus,
        TokenizedCorpusWriter,
        encode_corpus,
    )
    from haconvdr_torch.index.quantize import quantize_int8
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    rng = np.random.default_rng(seed + 3)
    lengths = rng.integers(32, ENC_LEN + 1, N_CORPUS).astype(np.int32)
    ids = rng.integers(3, cfg.vocab_size, (N_CORPUS, ENC_LEN)).astype(np.int32)
    ids[:, 0] = 0  # <s>
    ids[np.arange(N_CORPUS), lengths - 1] = 2  # </s>
    ids[np.arange(ENC_LEN)[None, :] >= lengths[:, None]] = 0  # the writer's padding
    qparams = quantize_encoder_params(params)
    enc = AnceEncoder.from_jax_params(qparams, cfg, dev)
    rows_dev = []
    n_fwd = [0]

    def encode_fn(ids_t, mask_t):
        out = enc(ids_t, mask_t)
        rows_dev.append(out.clone())
        n_fwd[0] += 1
        return out

    kw = dict(batch_size=ENC_BATCH, per_block_passage_num=ENC_BLOCK)
    with tempfile.TemporaryDirectory() as tmp:
        w = TokenizedCorpusWriter(f"{tmp}/corpus", max_seq_length=ENC_LEN)
        w.add_batch(np.arange(N_CORPUS, dtype=np.int64) * 5 + 3, ids, lengths)
        w.finalize()
        corpus = TokenizedCorpus(f"{tmp}/corpus")
        with torch.inference_mode():  # warm-up at the batch shape
            offs, b_ids, b_mask = next(corpus.batches(ENC_BATCH))
            enc(torch.from_numpy(b_ids).to(dev), torch.from_numpy(b_mask).to(dev))
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        store = encode_corpus(corpus, encode_fn, f"{tmp}/int8", store_dtype="int8",
                              device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        print("corpus encode launch counts:", json.dumps(counts), f"({n_fwd[0]} forwards)")
        check_counts(counts, [("fused_attention", "kernel"), ("fused_ln", "ln_quant"),
                              ("fused_mlp", "kernel")], "corpus encode")
        check(n_fwd[0] == N_CORPUS // ENC_BATCH, f"corpus encode: {n_fwd[0]} forwards")
        check_tower_counts(counts, n_fwd[0], cfg.num_hidden_layers, "corpus encode")
        rows = torch.cat(rows_dev).cpu().numpy()
        check(rows.shape == (N_CORPUS, cfg.embedding_dim) and np.isfinite(rows).all(),
              "corpus encode: rows not finite or misshapen")
        n_blocks = N_CORPUS // ENC_BLOCK
        check(store.num_blocks() == n_blocks, f"corpus encode: {store.num_blocks()} blocks")
        for b in range(n_blocks):
            codes, offsets = store.read_block(b)
            lo, hi = b * ENC_BLOCK, (b + 1) * ENC_BLOCK
            check(np.array_equal(offsets, np.arange(lo, hi)), f"block {b}: offsets out of order")
            want_codes, want_scale = quantize_int8(rows[lo:hi])
            check(np.array_equal(codes, want_codes)
                  and np.array_equal(store.block_scale(b), want_scale),
                  f"block {b}: codes are not quantize_int8 of the tower's rows")
        # ---- the plain-twin tower through the same encode_corpus, float32 blocks
        ref_enc = AnceEncoder.from_jax_params(qparams, cfg, dev, plain=True)
        ref_store = encode_corpus(corpus, ref_enc, f"{tmp}/ref", **kw)
        ref_rows = np.concatenate([ref_store.read_block(b)[0] for b in range(n_blocks)])
        err, cos = tower_agreement(rows, ref_rows, "corpus encode rows")
        check(isinstance(store, EmbeddingBlockStore), "encode_corpus returned no store")
    tokens = int(lengths.sum())
    metrics = dict(passages_per_s=N_CORPUS / secs, tokens_per_s=tokens / secs,
                   padded_tokens_per_s=N_CORPUS * ENC_LEN / secs, seconds=secs,
                   max_abs_err=err, min_cos=cos)
    print(f"corpus encode: {N_CORPUS} passages (lengths 32-{ENC_LEN}, {tokens} tokens) in "
          f"{secs:.3f} s into {n_blocks} int8 blocks; codes equal quantize_int8 of the "
          f"tower's rows; rows vs the plain-twin tower max |diff| {err:.3g}, min cosine "
          f"{cos:.7f}")
    print("corpus encode e2e:", json.dumps(metrics), f"[{card}]")
    del enc, ref_enc, rows_dev
    torch.cuda.empty_cache()
    return counts, metrics


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

def train_batch(seed: int, B: int, vocab: int):
    """A collate()-shaped batch: conversational queries of 64-512 tokens,
    passages of 32-384, every extra passage present for most rows."""
    rng = np.random.default_rng(seed)

    def toks(n, L, lo):
        lengths = rng.integers(lo, L + 1, n)
        ids = rng.integers(3, vocab, (n, L)).astype(np.int32)
        ids[:, 0] = 0  # <s>
        ids[np.arange(n), lengths - 1] = 2  # </s>
        mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
        return ids * mask, mask

    b = {}
    b["conv_qp"], b["conv_qp_mask"] = toks(B, TRAIN_QLEN, TRAIN_QLEN // 8)
    for key in ("pos_docs", "neg_docs", "pseudo_prepos_docs", "prepos_neg_docs"):
        b[key], b[f"{key}_mask"] = toks(B, TRAIN_PLEN, TRAIN_PLEN // 12)
    b["has_pseudo_prepos"] = (rng.random(B) < 0.8).astype(np.int32)
    b["has_prepos_neg"] = (rng.random(B) < 0.8).astype(np.int32)
    b["valid"] = np.ones(B, np.int32)
    return b


def train_setup(seed: int, dev, cfg, tcfg, plain: bool = False, rng_seed=None):
    """The train step, a fresh train state (dropout generator from
    ``rng_seed``, default ``seed``) and the int8 frozen tower; ``plain``
    runs the trained tower's plain twins (the frozen tower always runs
    the kernels)."""
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.train.trainer import (
        build_frozen_encoder,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    opt = make_optimizer(tcfg, total_steps=100)
    step = make_train_step(dev, cfg, tcfg, opt)
    model = AnceEncoder.from_jax_params(init_params_numpy(cfg, seed), cfg, dev, plain=plain)
    frozen = build_frozen_encoder(init_params_numpy(cfg, seed + 1), cfg, tcfg, dev)
    return step, init_train_state(model, opt, seed=seed if rng_seed is None else rng_seed), frozen


def eval_loss(state, frozen, batch, tcfg, dev) -> float:
    """The batch's loss with dropout off, the query tower in eval mode."""
    from haconvdr_torch.train.trainer import batch_loss, batch_to_device

    with torch.no_grad():
        return float(batch_loss(state.model, frozen, batch_to_device(batch, dev), tcfg,
                                trainable=False))


def check_train_counts(counts, layers: int, n_frozen: int, n_micro: int) -> None:
    """Per micro step: flash fwd and bwd once a layer (remat "mlp" reruns
    no attention), and per frozen int8 bf16 forward 1 + layers
    LayerNorm-quant, layers MLP and layers inference attention launches."""
    want = {("flash_attention", "fwd"): layers, ("flash_attention", "bwd"): layers,
            ("fused_ln", "ln_quant"): (1 + layers) * n_frozen, ("fused_ln", "ln"): 0,
            ("fused_mlp", "kernel"): layers * n_frozen,
            ("fused_attention", "kernel"): layers * n_frozen}
    for (mod, key), n in want.items():
        check(counts[mod][key] == n * n_micro,
              f"training: {mod} {key} launched {counts[mod][key]} times in {n_micro} micro "
              f"steps, not {n} each")
    check_counts(counts, list(want)[:2], "training")


def phase_training(seed: int, dev, card: str):
    """Phase 9 at the reference geometry; returns (launch counts, metrics)."""
    from haconvdr_torch.config import ModelConfig, TrainConfig

    cfg = ModelConfig(dtype="bfloat16", remat="mlp")  # dropout 0.1 (the defaults)
    tcfg = TrainConfig(per_device_train_batch_size=TRAIN_B, accumulation_steps=TRAIN_ACC,
                       learning_rate=TRAIN_LR, num_warmup_portion=0.0, weight_decay=0.01,
                       max_grad_norm=1.0, is_pseudo_prepos=True, is_prepos_neg=True,
                       frozen_dtype="int8")
    L, n_frozen = cfg.num_hidden_layers, 4
    # ---- (a) one micro step with the trained tower through the kernels and
    # one through its plain twins, from the same state, batch and dropout
    # draws; the frozen towers run the int8 kernels on both sides, so only
    # the flash kernels differ.  A third step through the kernels with
    # other dropout draws shows how far a mask that differs moves the
    # gradients: it must land outside the bound
    batch = train_batch(seed + 30, TRAIN_B_CHECK, cfg.vocab_size)
    got = {}
    for run, plain, rng_seed in (("kernels", False, seed + 40), ("plain", True, seed + 40),
                                 ("other draws", False, seed + 41)):
        step, state, frozen = train_setup(seed + 40, dev, cfg, tcfg, plain=plain,
                                          rng_seed=rng_seed)
        zero_counts()
        _, loss = step(state, frozen, batch)
        got[run] = (float(loss), torch.cat([gr.flatten() for gr in state.accum_grads.values()])
                     .double(), read_counts())
        del step, state, frozen
        torch.cuda.empty_cache()
    (lk, gk, ck), (lp, gp, cp), (lo, go, _) = got["kernels"], got["plain"], got["other draws"]
    check_train_counts(ck, L, n_frozen, 1)
    check(cp["flash_attention"] == {"fwd": 0, "bwd": 0, "plain_fwd": L, "plain_bwd": L},
          f"training (plain): flash launches {cp['flash_attention']}")
    for mod in ("fused_ln", "fused_mlp", "fused_attention"):
        check(cp[mod] == ck[mod], f"training (plain): the frozen towers' {mod} launches differ")
    grad_rel = float((gk - gp).norm() / gp.norm())
    other_rel = float((go - gk).norm() / gk.norm())
    check(np.isfinite(lk) and abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp)
          and grad_rel <= TRAIN_GRAD_REL,
          f"training: kernels vs plain twins: loss {lk} vs {lp}, gradients {grad_rel} apart")
    check(other_rel > TRAIN_GRAD_REL,
          f"training: other dropout draws move the gradients by only {other_rel}")
    print(f"training (a) B {TRAIN_B_CHECK}: kernels vs plain twins loss {lk:.6f} vs {lp:.6f}, "
          f"gradients {grad_rel:.3e} apart (|g| {float(gk.norm()):.4f} vs "
          f"{float(gp.norm()):.4f}); other dropout draws: loss {lo:.6f}, "
          f"gradients {other_rel:.3e} apart")
    del got, gk, gp, go
    # ---- (b) timed micro steps at B 64 on one repeated batch
    step, state, frozen = train_setup(seed + 50, dev, cfg, tcfg)

    def checksum():
        return sum(float(t.double().sum()) for t in frozen.state_dict().values())

    before = checksum()
    batch = train_batch(seed + 60, TRAIN_B, cfg.vocab_size)
    eval_before = eval_loss(state, frozen, batch, tcfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    zero_counts()
    for _ in range(TRAIN_MICRO):
        t = time.perf_counter()
        _, loss = step(state, frozen, batch)
        losses.append(float(loss))  # a host sync: the step has finished
        secs.append(time.perf_counter() - t)
    counts = read_counts()
    print("training launch counts:", json.dumps(counts), f"({TRAIN_MICRO} micro steps)")
    check_train_counts(counts, L, n_frozen, TRAIN_MICRO)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    eval_after = eval_loss(state, frozen, batch, tcfg, dev)
    check(all(np.isfinite(losses)), f"training: non-finite loss {losses}")
    check(eval_after < eval_before,
          f"training: the eval loss did not fall over the repeated batch (lr {TRAIN_LR}): "
          f"{eval_before} -> {eval_after}; training losses {losses}")
    check(state.global_step == TRAIN_MICRO // TRAIN_ACC, "training: wrong update count")
    check(checksum() == before, "training: the frozen tower changed")
    # ---- device time of one accumulation window (TRAIN_ACC micro steps)
    # under torch.profiler, against that window's own wall time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(TRAIN_ACC):
            step(state, frozen, batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}  # device ms by the first 70 characters of the kernel's name
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:70]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    dev_ms = sum(by_name.values())
    check(dev_ms > 0, "training: the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    timed = secs[TRAIN_WARM:]  # every micro step after the warm-up ones
    med = float(np.median(timed))
    metrics = dict(examples_per_s=TRAIN_B * len(timed) / sum(timed),
                   examples_per_s_median_step=TRAIN_B / med, micro_step_ms_median=med * 1e3,
                   micro_step_ms=[x * 1e3 for x in secs], losses=losses, lr=TRAIN_LR,
                   eval_loss=[eval_before, eval_after], peak_memory_gib=peak_gib,
                   profiled_wall_ms=prof_wall_ms, device_ms=dev_ms,
                   idle_share=1.0 - dev_ms / prof_wall_ms,
                   unprofiled_window_wall_ms=sum(secs[-TRAIN_ACC:]) * 1e3,
                   kernel_vs_plain=dict(loss=[lk, lp], grad_rel=grad_rel),
                   other_draws=dict(loss=lo, grad_rel=other_rel),
                   top_device_ms=dict(top))
    print(f"training (b): {TRAIN_MICRO} micro steps of B {TRAIN_B} (query {TRAIN_QLEN}, "
          f"passages {TRAIN_PLEN}, 4 int8 frozen towers), losses "
          + ", ".join(f"{x:.4f}" for x in losses) + f" at lr {TRAIN_LR}; eval loss (no "
          f"dropout) {eval_before:.4f} -> {eval_after:.4f}; frozen tower unchanged")
    print("training e2e:", json.dumps(metrics), f"[{card}]")
    del step, state, frozen
    torch.cuda.empty_cache()
    return counts, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2

    from haconvdr_torch.config import ModelConfig
    from haconvdr_torch.device import resolve_device
    from haconvdr_torch.index.quantize import quantize_int8_torch
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.ops import _build

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    _build.library()
    print(f"build: {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s "
          f"nvcc (0 = loaded from build/haconvdr_torch/) [{card}]")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    passages = torch.randn(N_ROWS, DIM, device=dev, generator=g)
    codes, scale = quantize_int8_torch(passages)
    rows = phase_kernels(args.seed, dev, passages, codes, scale)
    del codes
    torch.cuda.empty_cache()
    for r in rows:
        print("kernel vs plain:", json.dumps(r), f"[{card}]")

    cfg = ModelConfig()  # ANCE RoBERTa-base: 12 x 768, 12 heads, 3072, 50265
    params = init_params_numpy(cfg, args.seed)
    c4, e2e, queries = phase_main_path(args.seed, dev, passages, params, cfg, card)
    c5, e2e8, scale8 = phase_int8_path(args.seed, dev, passages, params, cfg, card)
    check(torch.equal(scale8, scale), "int8 path: index scale differs from quantize_int8_torch")
    c6 = phase_streaming(dev, passages, scale, queries)
    c7, _, _ = phase_int8_tower(args.seed, dev, passages, params, cfg, card)
    del passages
    torch.cuda.empty_cache()
    c8, _ = phase_corpus_encode(args.seed, dev, params, cfg, card)
    c9, _ = phase_training(args.seed, dev, card)
    print(f"phases done in {time.perf_counter() - t_start:.1f} s [{card}]")

    def launches(mod, key):
        return sum(c[mod][key] for c in (c4, c5, c6, c7, c8, c9))

    def entry(name, source, replaces, mod, key, main_config="float32"):
        mine = [r for r in rows if r["kernel"] == name]
        main_row = next(r for r in mine if r["config"] == main_config)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches(mod, key),
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}

    v4src = "haconvdr_torch/csrc/topk_v4.cu"
    v4py = "haconvdr_tpu/ops/pallas_topk_v4.py"
    print(json.dumps({"kernels": [
        entry("fused_attention", "haconvdr_torch/csrc/fused_attention.cu",
              "haconvdr_tpu/ops/fused_attention.py:30", "fused_attention", "kernel"),
        entry("fused_topk", "haconvdr_torch/csrc/fused_topk.cu",
              "haconvdr_tpu/ops/pallas_topk.py:63", "fused_topk", "kernel"),
        entry("window_top2", v4src, f"{v4py}:98", "topk_v4", "window"),
        entry("select_topk_t", v4src, f"{v4py}:612", "topk_v4", "select_t", "cold"),
        entry("rescore_windows", v4src, f"{v4py}:522", "topk_v4", "rescore"),
        entry("select_topk", v4src, f"{v4py}:386", "topk_v4", "select", "cold"),
        # row 8 lies on no path of either package: phase 3 checks it alone
        entry("fused_ln", "haconvdr_torch/csrc/fused_ln.cu",
              "haconvdr_tpu/ops/fused_ln.py:66", "fused_ln", "ln", "bf16, no residual"),
        entry("fused_ln_quant", "haconvdr_torch/csrc/fused_ln.cu",
              "haconvdr_tpu/ops/fused_ln.py:91", "fused_ln", "ln_quant", "bf16 + residual"),
        entry("fused_mlp", "haconvdr_torch/csrc/fused_mlp.cu",
              "haconvdr_tpu/ops/fused_mlp.py:56", "fused_mlp", "kernel", "bf16"),
        entry("flash_attention_fwd", "haconvdr_torch/csrc/flash_attention.cu",
              "haconvdr_tpu/ops/flash_attention.py:105", "flash_attention", "fwd",
              FLASH_MAIN),
        entry("flash_attention_bwd", "haconvdr_torch/csrc/flash_attention.cu",
              "haconvdr_tpu/ops/flash_attention.py:174", "flash_attention", "bwd",
              FLASH_MAIN),
    ]}))
    print(f"total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
