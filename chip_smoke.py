#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (haconvdr_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--only experts|dense]

Run from the repository root, with one CUDA card visible.  Phases, in
order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile haconvdr_torch/csrc/*.cu with nvcc into
   build/haconvdr_torch/ (first use; one nvcc per source, run at once)
   and print the build time;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card at
   the serving path's shapes (Q = 256, N = 2,500,000 with n_valid =
   N - 1,000, D = 768, k = 100), with the max error and both times:
   attention, and its head-split [B, H, L, d] wrapper (fused_attention)
   on the same heads; the v3 top-k in f32, bf16 and its int8 mode,
   unseeded and seeded, at Q 256 and, from its own generator, at Q 1, 64,
   256 and 512 (ROW2_QS), and unseeded with presample=-1 (the sampled
   threshold alone) at Q 1, 64 and 256 (PRESAMPLE_QS); each wrapper piece
   (head-split, presample) must launch its kernel once and no plain twin,
   counts zeroed just before; the v4 window kernel (row 3) at Q 256 and, on the routes
   window_route names (a, the streaming route, at one query; b or c, the
   tiled routes, at 64), at Q 1 and 64, where it must also equal
   rescore_windows bit for bit on each query's own flagged windows, with a
   context line timing torch.matmul of the same float32 operands at Q 256
   (scores only); the rescore kernel (row 5) at Q 1, 8 and 256 on 7
   random windows and an empty slot a query, bit for bit against the
   window kernel's max, its row and second max; the select kernel in both
   layouts at Q 256, 7 and 1, split (the path's route) and in one launch,
   on the panels the path hands it: the window maxima v1T [W, Q] at k 100
   and the flagged second maxima at k = budget (both cold), the pool
   [W + 8 sw, Q] cold, and warm (a floor from warm_floor) at the wider pool
   of a 1.7M-row search, where it must also equal the cold answer; then one
   `redesigned select_topk[_t] ...` line per panel (device ms, torch.topk ms,
   bound, ms / torch.topk); the whole v4 search in f32, bf16 and int8, and a
   forced fallback to v3 (planted duplicate rows); the int8 tower's kernels
   at the corpus-encode batch (256 x 384 = 98,304 rows, H 768, I 3072):
   LayerNorm with a bf16 residual and without one (also at H 256, the
   generic kernel beside the H 768 one), LayerNorm-quant with a bf16
   residual and with a float32 input and none, and the int8 MLP block at
   512 rows (one request), 24,576 (the train-ref frozen towers) and
   98,304; the trained
   tower's flash-attention forward and backward at B 8, L 512, 12 heads,
   float32 and bfloat16, dropout 0 and 0.1, at phase 9's shape (B 64,
   query lengths 64-512, bfloat16, dropout 0.1 and 0) and at phase 11's
   (the same in float32, dropout 0.1; the same seed words to both); the streaming top-k (row 7, on no path) at Q =
   256 over the first 2,498,560 rows (a multiple of both dtypes' p_chunk *
   group),
   n_valid = N - 1,000, float32 and bfloat16, also bit for bit against the
   unseeded v3 kernel on the same rows, and in float32 at k 129 and 1,024
   (past the other kernels' 128); attention (row 1) in bfloat16 and
   in float32 at the frozen passage towers' shape (B 64, L 384, lengths
   32-384);
   then one `redesigned ...` line per row of a redesigned route (rows 1,
   11 and 12: bf16 on the tensor cores, f32 in 3xTF32):
   ms, SDPA ms (row 12: SDPA's backward alone, then forward + backward
   against SDPA's forward + backward), bound ms and ms / SDPA, with the
   card's name and power limit; one per case of rows 8-10 and of row
   7 (k 100, 129 and 1,024, device ms): ms, plain ms, library ms, bound
   ms and ms / bound; one per mode and Q (1, 8, 256) of row 5: device
   ms, bound ms, ms / bound and plain ms; and
   one per mode and Q (1, 64, 256) of row 3: device ms, the route, the
   bound at the route's rate and ms / that bound; one per mode, Q of
   ROW2_QS and seed of row 2: device ms, plain ms, the bound at the
   passages' type and ms / bound, then, as context, the bound at the fmaf
   chain's f32 rate (every mode runs the f32 chain on the CUDA cores) and
   ms / that bound;
   each row also carries its bound (bytes over 3.35 TB/s or operations
   over the peak of the type the work could run in) and, where one
   PyTorch call computes the same function, that call's time;
4. main path: a full-width ANCE RoBERTa-base query tower (random weights
   from the seed) over a resident 2,500,000 x 768 float32 index made on
   the card, searched by the v4 kernels; a BatchingRetriever(max_batch=64)
   answers concurrent conversational requests and Retriever.retrieve a
   few single ones.  Answers are held against the plain twins, and the
   window kernel's launches by route against the routes window_route names
   for the Q of each search (single requests on route a, larger
   dispatches on b); then the embed of 64 requests is timed (median of 3,
   host clock, synchronized);
5. int8 resident path: the same tower, Retriever(store_dtype="int8") over
   the same rows quantized on the card; 64 concurrent requests and a few
   single ones.  Every search's answer equals the plain int8 scoring of
   the same query embeddings: ids at every position, scores bit for bit;
   the window kernel ran routes a and c, as window_route names them;
6. streaming path: BlockSearcher over the same rows as four 625,000-row
   device blocks: per block (unseeded v3 first, then seeded v3), and as
   super-blocks of 2,500,000 rows (one v4 search per fill) in float32 and
   with the int8 accumulator.  Answers are held against the plain twins.
7. int8 tower serving: Retriever(encoder_int8=True) with
   ModelConfig(dtype="bfloat16") over the phase-4 index; 64 concurrent
   requests and a few single ones.  Each forward launches LayerNorm-quant
   13 times and the MLP kernel 12 times; the searches equal the plain
   search of the same embeddings, and the embeddings agree with the
   plain-twin tower on the same batches; then the embed of the 64
   requests' batch is timed (median of 3, host clock, synchronized);
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
   wall time), the attention kernels' share of that device time and the
   top device operations;
10. offline evaluation (retrieval.py) at full width: 64 TopiOCQA-format
   conversations of 8 turns (512 test queries, convqp inputs up to 512
   tokens, HashTokenizer) through the float32 tower at batch 64, then
   gen_metric_score_and_save over an on-disk EmbeddingBlockStore of two
   float32 blocks (2,500,000 rows: the v4 search; 500,000 rows: the seeded
   v3 kernel; N(0, 1) rows made on the card) in a temporary directory,
   with every query's embedding planted at a seeded offset, a seeded
   offset2pid read back through passage_offset2pid_path and a qrel file of
   the golds: MRR, NDCG@3, Recall@10 and Recall@100 must be 100.0, and the
   TREC run must equal the plain twins' exact top-100 of the same
   embeddings over the same rows.  Then run_prj_labeling, with its own
   encode, over 96 probes of 32 conversations (-0..-2), a seeded subset of
   the non-base probes planted with gold qrels: the labels must equal the
   plants.  It prints seconds per stage, queries/s and peak memory;
11. f32 training at the repo's own TOML geometry
   (configs/topiocqa_train.toml through load_config: f32 trained and frozen towers, remat "mlp",
   dropout 0.1, B 64, query 512, passages 384, is_prepos_neg: three frozen
   forwards a micro step), cut to accumulation TRAIN_ACC (not 8) and
   TRAIN_LR (not 1e-5): TRAIN_MICRO micro steps on one repeated batch with
   exact launch counts (flash fwd and bwd 12 each, f32 inference attention
   12 x 3, no int8 kernel, no plain twin), finite losses, the frozen tower
   unchanged; examples/s, peak memory, and one profiled accumulation
   window's idle share and the attention kernels' shares;
12. load and serve over HTTP: phase 4's rows (regenerated from the seed)
   written as an EmbeddingBlockStore of one 2,500,000 x 768 float32 block
   with an offset2pid pickle, and phase 4's tower as an HF checkpoint
   (save_hf_checkpoint), under the first of the temporary directory and
   build/ with room, beside offline byte-level tokenizer files;
   Retriever.load reads them back onto the card through the installed
   RobertaTokenizer (its seconds printed; without transformers a stand-in
   module hands out HashTokenizer, as phase 4 used), and its
   tower must equal phase 4's and
   its index phase 4's rows bit for bit.  RetrievalServer(max_batch=64,
   max_wait_ms=2.0) answers one lone POST /retrieve, then 128 concurrent
   clients (phase 4's requests, one thread each), then one
   /retrieve_batch of 64, /healthz and /stats, and close(); a request
   after close() must be refused.  Every answer holds k hits and agrees
   with Retriever.search and a sequential Retriever.retrieve of its
   request (the HTTP rule below); /stats counts every request
   served, 0 errors, and a dispatch of more than one request; the window
   kernel's launches match the routes of the dispatched batch sizes.  It
   prints requests/s over the burst, /stats' p50 / p90 / p99 and the
   dispatch histogram;
13. the IVF serving tier: a 2,500,000 x 768 Gaussian mixture (64
   unit-norm modes plus noise, made on the card from the seed) written as
   one float32 store block under the first of the temporary directory and
   build/ with room; cli/build_ivf (nlist 1024, nprobe 32, bfloat16) into
   an ivf_dir; Retriever(ivf=True, ivf_dir=...) with phase 4's f32 tower
   reloads it, and its index and answers must equal the build's bit for
   bit; an in-process residual-int8 build (rescore_oversample 3).  At
   nprobe = nlist the IVF answers must equal the flat bf16 v4 search (the
   buckets' scoring model), and ivf_search on the card the CPU's for 8
   queries (the top-k rule below); recall@100 at nprobe 32 must reach
   0.99.  300 single requests through the IVF retriever and flat f32 and
   bf16 ones in turn, and 128 concurrent clients through
   BatchingRetriever(max_batch=16) over IVF and flat bf16: each IVF
   answer must equal its dispatch (or single call) run again.  It prints build, save, load and reload
   seconds, the buckets' bytes, recall@100 against the flat search at
   nprobe 8, 32 and 64, the search ms at Q 1, 8 and 64 beside the flat v4
   search (CUDA events and torch.profiler's device ms), single-request
   percentiles and requests/s, IVF against flat.  Its store and build stay
   for phase 14;
14. the multi-device layer (parallel/mesh.py) as four shard slots on the
   one card, make_mesh(devices=[cuda:0] * 4): (a) phase 4's rows,
   regenerated from the seed, as a ShardedIndex on the mesh (shards of
   655,360 rows, JAX's cut) in float32, bfloat16 and int8 at Q 1, 64 and
   256, k 100 (the v4 search, and kernel="v3") and k 300 (the plain path):
   float answers equal the one-shard index's, int8 the plain scoring of
   each shard with its own scale merged; each v4 kernel launched once a
   search on each non-empty shard and no plain twin; search ms sharded
   beside one shard at Q 1 and 256 (events and profiler device ms, context
   only); then ShardedIndex.from_store(mesh, ...) of phase 13's store
   equal to the tensor build, shard for shard; (b)
   build_ivf_from_store on the mesh from phase 13's store (nlist 1024,
   bfloat16): centroids and each shard's clusters equal phase 13's
   one-shard build, its answers at nprobe 32 that build's, at nprobe =
   nlist the flat bf16 search's; a 4-shard save reloaded onto one slot and
   onto four; (c) Retriever(mesh=...) over the f32 rows: 64 concurrent
   requests through BatchingRetriever(max_batch=64) and single ones, each
   equal to its dispatch run again, and within phase 12's rule of the one-slot
   Retriever's sequential answer; (d) two processes on the card (this
   script with --mp-child, a gloo group for barriers only, a timeout
   each): the per-process save_ivf_sharded / load_ivf_sharded round trip
   and the stride encode of phase 8's corpus through the int8 bf16 tower
   into float32 blocks, which rank 0 stitches and holds to a single-pass
   encode bit for bit.  It prints the IVF build seconds on four slots
   against one and the two processes' seconds;
15. training on a mesh and the tensor-parallel encode, on MESH_SLOTS
   slots of the one card (every visible card when there are several):
   (a) phase 9's geometry (B 64 as dp slots of 16, query 512, passages
   384, bf16, remat "mlp", dropout 0.1, four int8 frozen towers,
   accumulation 2) through make_train_step on the mesh and on one slot,
   from one state, two batches and one dropout generator: each micro
   step's loss, the first micro step's gradients and the update itself
   (params after less params before) against the one slot's, the
   replicas bit-equal (one replica a distinct card: on one card there
   is a single replica and the check holds trivially); then, on
   each in turn, TRAIN_MICRO timed micro steps (examples/s, one slot
   beside the mesh in one call, and phase 9's) and one profiled
   accumulation window (the device idle share); each micro step
   launches rows 11-12 once a layer a slot and the frozen towers' rows
   1, 9 and 10 a slot, no plain twin; (b) rows
   11-12 on rows OFFSET_ROWS of phase 9's B 64 (bf16) and phase 11's
   (f32) shapes with row_offset = the first row: output, row stats and
   dqkv bit for bit against those rows of the whole-batch launch, the
   plain twins with the same offset at rows 11-12's tolerances, device
   ms beside offset 0's; (c) phase 8's int8 bf16 tower (and the f32
   tower) split by shard_params(tp=True) over dp 1 x tp 4 and dp 2 x tp
   2 through dp_encode_fn at ENC_BATCH x ENC_LEN: the int8 rows equal
   the un-split tower's on the same dp slices bit for bit, the f32 rows
   within TP_F32_REL; exact launch counts (row 1 a layer a rank, row 9
   once a layer and once more a dp row, row 10's split mode: up and down
   a layer a rank, finish a layer a dp row, no un-split block); then row
   10's split mode at 98,304 rows, tp 2 and 4: bit for bit the un-split
   kernel's, within row 10's bounds of its plain twin, device ms beside
   the un-split block's, plain ms and the bound.  It prints its seconds.
16. the expert layer (ops/moe.py, csrc/moe_experts.cu: row 13) at the
   DeepSeek-V2 cell's shape (MOE_T = 21,000 tokens, H 2048, I 1408, 64
   experts, top 6, random bf16 weights): with the routing of random
   weights and with every token moved along expert 0's router row so that
   it takes about half the tokens (MOE_SHIFT), one call each with the
   launch counts zeroed just before (three launches, no twin), the largest
   load read from the device accumulators, the plain twin, device ms over
   MOE_REPS calls, the bound (2 x T x 6 x 3 x H x I operations at the bf16
   peak, or the bytes) and torch._grouped_mm's ms for the same grouped
   products.  ``--only experts`` runs phases 1, 2 and 16 alone.
17. the int8 dense (ops/int8_dense.py, csrc/int8_dense.cu: row 14) at the
   int8 cells' shapes (DENSE_ROWS: 53,248 and 9,000 rows): the QKV dense
   (768 -> 2,304 from given codes) and the attention-output dense (768 ->
   768 from bf16 rows: the codes kernel, then the dense), bf16 out; one
   call each with the launch counts zeroed just before, bit for bit the
   plain twin (the composition of quantize_rows, torch._int_mm and the
   elementwise dequantization it replaced), device ms over DENSE_REPS
   calls, the twin's ms, torch._int_mm's alone (the library) and the bound
   (the products at the int8 peak, or the input, W and the bf16 y once).
   ``--only dense`` runs phases 1, 2 and 17 alone.
Each of phases 4-17 zeroes every launch count just before it (phase 10:
before the encode, the search and the labeling; phase 14: before each
search, serving run and encode of its path, in the children too; phase
15: before each training run and each split encode) and reads them just
after: each kernel of that path must have launched, and no plain twin
may have run.  The kernel line counts row 10's split mode (one launch a
split block, at its finish) with row 10.

Tolerances (kernel vs plain twin on the same inputs):
  attention float32  max |diff| <= 1e-4 (3xTF32 products, ~2^-21 relative
                     each, at the level of an f32 fmaf chain; one-term
                     TF32 would not hold it)
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
  flash attention    float32 out and dqkv max |diff| <= 1e-5 (3xTF32
                     products; one-term TF32 would not hold it); bfloat16
                     out within one bf16 ulp of its largest magnitude,
                     and dQ, dK and dV each within one bf16 ulp of its
                     own (both round P, dS and the outputs to bf16)
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
  streaming top-k    as float scores above, and equal to the unseeded v3
                     kernel bit for bit (one fmaf chain, one merge)
  presample          as top-k ids and scores above against its plain
                     twin, and equal to the unseeded kernel bit for bit
                     with no id -1 (the threshold prunes no answer row)
  head-split         as attention above, and equal to the kernel on the
                     fused projection bit for bit (the same operands)
  offline eval run   as top-k ids and scores above, against the plain
                     twins' top-100
  IVF (phase 13)     as top-k ids and scores above: full probe against
                     the flat bf16 search, the card against the CPU (two
                     float32 sums of exact products in another order); a
                     reload, and every served answer against its
                     dispatch run again, bit for bit
  mesh (phase 14)    through the kernels, bit for bit: float sharded
                     answers against the one-shard index (one fmaf chain a
                     row), int8 v4 against the per-shard int8 x int8
                     scoring; k 300 (the plain path's GEMMs) and int8 v3
                     against the plain GEMM: as top-k ids and scores above
                     (whether they were bit for bit too is printed); the
                     sharded IVF against the one-shard build, the 1-slot
                     reload against the 4-shard build, full probe against
                     the flat bf16 search: as top-k ids and scores above
                     (the probed buckets are scored in batched products of
                     other shapes); the 4-slot reload, from_store against
                     the tensor build, the stitched encode and every served
                     answer against its dispatch run again: bit for bit;
                     against the one-slot
                     Retriever: phase 12's rule
  HTTP answers       bit for bit their dispatch run again (the tower packs
                     a batch to its rows' lengths, so a row's embedding
                     depends on the token rows it was batched with);
                     against a sequential Retriever.retrieve
                     (batch 1): scores within 1e-4 |ref| + delta, ids
                     where the neighbouring scores (the 101st included)
                     differ by more than 1e-5 |s| + 2 delta, delta =
                     ||q_batch - q_1|| x the index's largest row norm,
                     with ||q_batch - q_1|| <= 1e-5 ||q_1|| and at least
                     half the ranks so separated (phase 12)
  train micro step   the trained tower through the kernels vs through
                     its plain twins, the same int8 frozen towers (phase
                     9a): loss within TRAIN_LOSS_RTOL = 1% and the whole
                     gradient vector within TRAIN_GRAD_REL = 5% of the
                     twin's norm: the two differ only where a bf16 ulp of
                     attention output or dqkv differs, which the bf16
                     GEMMs of 12 layers spread; a step with other dropout
                     draws must sit beyond TRAIN_GRAD_REL
  mesh micro step    the mesh step against the one-slot step (phase
                     15a): each loss within TRAIN_LOSS_RTOL, the first
                     micro step's gradients and the update (params
                     after less params before: against the whole
                     params one step moves too little to show a fault)
                     within TRAIN_GRAD_REL of the one slot's norm (the
                     same masks: each slot draws its rows' of the whole
                     batch; bf16 GEMMs of other heights round
                     otherwise); the replicas bit-equal, which holds
                     trivially on one card (one replica a distinct
                     device: a single replica there)
  row offset         rows 11-12 on a slice with row_offset = its first
                     row: bit for bit the whole-batch launch's rows (each
                     (b, h) tile is computed alone); against the twins
                     as flash attention above
  tp encode          int8 bf16 tower split over tp: bit for bit the
                     un-split tower's on the same dp slices (every code
                     and int32 sum is the un-split tower's); f32 tower:
                     max |diff| <= TP_F32_REL = 1e-4 of max |ref| (JAX's
                     tests/test_parallel.py bound); row 10's split mode
                     bit for bit the un-split kernel's, against its twin
                     as the int8 MLP block above
  expert layer       each row within MOE_REL = 1% of its norm of the plain
                     twin's (both round the same intermediates to bf16 and
                     sum in float32, in an order that may differ; at phase
                     16's shape every element came out equal; a wrong
                     expert, weight or row reads ~100%); the row's
                     ``max_abs_err`` is that relative error, and the line
                     counts the elements that differ

The line before the last is the card's nvidia-smi name and power limit;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = pathlib.Path(__file__).resolve().parent  # the checkout this script drives

N_ROWS = 2_500_000
N_PAD = 1_000  # rows past n_valid in phase 3
DIM = 768
TOP_K = 100
Q_KERNEL = 256
ATTN_B, ATTN_L = 8, 512
ATTN_REPS = 30  # timed launches of an attention forward and of its SDPA yardstick
N_BATCHED = 128  # two full max_batch=64 dispatches
N_BATCHED_INT8 = 64
N_SINGLE = 4
N_BLOCKS = 4  # phase 6: 625,000-row blocks
WARM_POOL = 13_282 + 4 * 128  # the v4 pool of 1.7M float32 rows (sw 128)
SELECT_QS = (Q_KERNEL, 7, 1)  # phase 3's select panels: all queries, a non-multiple of 8, one
SELECT_REPS = 20
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
TRAIN_TOML = "configs/topiocqa_train.toml"  # phase 11, read beside this script
FLASH_MAIN = f"bfloat16, drop 0.1, B {TRAIN_B}"  # rows 11-12 at phase 9's shape
FLASH_F32 = f"float32, drop 0.1, B {TRAIN_B}"  # rows 11-12 at phase 11's shape
# row 1 at the frozen towers' shape: int8 bf16 towers (phase 9), f32 towers (phase 11)
ROW1_FROZEN = f"bfloat16, B {TRAIN_B} L {TRAIN_PLEN}"
ROW1_FROZEN_F32 = f"float32, B {TRAIN_B} L {TRAIN_PLEN}"
# row 7 (phase 3): the first rows of the index, a multiple of both dtypes'
# p_chunk * group (1220 x 2048 = 610 x 4096)
N_STREAM = 2_498_560
STREAM_WIDE_K = (129, 1024)  # row 7 past KMAX = 128 (phase 3)
MLP_ROWS = (512, 24_576, ENC_BATCH * ENC_LEN)  # row 10: one request, train-ref, corpus encode
# phase 10: 64 TopiOCQA-format conversations of 8 turns over a store of the
# reference's 2.5M-row faiss block and a 500,000-row second block; PRJ over
# 32 conversations' probes -0..-2, PRJ_PLANTED of the 64 non-base ones planted
EVAL_CONVS, EVAL_TURNS = 64, 8
EVAL_BLOCKS = (2_500_000, 500_000)
PRJ_CONVS, PRJ_PLANTED = 32, 24
WORDS = [f"w{i}" for i in range(5000)]
# the card's peaks (NVIDIA H100 SXM data sheet, dense) and memory rate;
# f32 is the CUDA cores' rate, tf32 the tensor cores'
PEAK = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
# row 2 (the v3 kernel) in phase 3's redesigned lines: a single request,
# a full dispatch of BatchingRetriever(max_batch=64), Q_KERNEL, and 512
ROW2_QS = (1, 64, Q_KERNEL, 512)
PRESAMPLE_QS = (1, 64, Q_KERNEL)  # row 2 with presample=-1 (phase 3)
# row 3 (the window kernel) beside Q_KERNEL: a single request, and the
# largest dispatch of BatchingRetriever(max_batch=64)
WINDOW_QS = (1, 64)
# row 5 (the rescore kernel): a single request, a small batch, Q_KERNEL
RESCORE_QS = (1, 8, Q_KERNEL)
# the rate each route of row 3 does its operations at: fmaf on the CUDA
# cores (A and B, float modes), dp4a (A, int8: four int8 products an
# instruction at the fmaf rate), the int8 tensor cores (C)
# phase 16: the expert layer (ops/moe.py) at the DeepSeek-V2 cell's shape: the
# packed token rows of a full dispatch (~21,000 measured with ANCE on the
# same mix), H 2048, I 1408, 64 experts, top 6; MOE_SHIFT moves every token
# along expert 0's router row so that it takes about half the tokens (a
# largest load ~5x the mean, as the cell's random router reads)
MOE_T, MOE_H, MOE_I, MOE_E, MOE_K = 21_000, 2048, 1408, 64, 6
MOE_SHIFT, MOE_REL, MOE_REPS = 1.35, 0.01, 10
# phase 17: the int8 dense (ops/int8_dense.py) at the encode cell's packed rows
# a batch (~53,000 of 256 x 384 slots) and an open-cell dispatch's (~9,000)
DENSE_ROWS, DENSE_REPS = (53_248, 9_000), 20
WINDOW_RATE = {("a", "float32"): PEAK["f32"], ("a", "bfloat16"): PEAK["f32"],
               ("a", "int8"): 4 * PEAK["f32"], ("b", "float32"): PEAK["f32"],
               ("b", "bfloat16"): PEAK["f32"], ("c", "int8"): PEAK["int8"]}


def model_config():
    """ANCE RoBERTa-base: 12 x 768, 12 heads, 3072, 50265 (the towers of
    phases 4-8, 10 and 12-14, and of phase 14's child processes)."""
    from haconvdr_torch.config import ModelConfig

    return ModelConfig()


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
    over the peak of the type they run in and the bytes over the memory
    rate."""
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


def chain_bound(p, Q: int, n_valid: int, name: str, out_bytes: int) -> dict:
    """Row 2's bound: search_bound (the operations at the peak of the
    passages' own type, or the bytes), and beside it, as context,
    chain_bound_ms: the same operations at the CUDA cores' f32 rate, the
    rate its fmaf chain runs at in every mode (bf16 and int8 operands are
    widened to floats), so ms / chain_bound_ms shows the tile's own
    shortfall and bound_ms what the exact chain costs."""
    chain, _ = bound(2.0 * Q * n_valid * DIM, p.numel() * p.element_size() + Q * DIM * 4
                     + out_bytes, "f32")
    return {**search_bound(p, Q, n_valid, name, out_bytes), "chain_bound_ms": chain}


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
        topk_stream,
        topk_v4,
    )

    from haconvdr_torch.ops import int8_dense, moe

    return {"fused_attention": fused_attention, "fused_topk": fused_topk, "topk_v4": topk_v4,
            "fused_ln": fused_ln, "fused_mlp": fused_mlp, "flash_attention": flash_attention,
            "topk_stream": topk_stream, "moe": moe, "int8_dense": int8_dense}


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


class DispatchLog:
    """Every tower call of one Retriever while it serves (``encode`` and the
    ``search`` that follows it on the same thread, patched on the instance),
    so that a check can run each again as it ran.  The tower packs a batch
    to its rows' lengths (ops/pack.py): a row's float32 embedding depends on
    the token rows it was batched with (the GEMMs' row count), so an answer
    is held to its own dispatch run again."""

    def __init__(self, retriever):
        self.retriever = retriever
        self.encode, self.search = retriever.encode, retriever.search
        self.runs, self._open = [], {}
        retriever.encode, retriever.search = self._encode, self._search

    def _encode(self, batches):
        batches = list(batches)
        self._open[threading.get_ident()] = batches
        return self.encode(batches)

    def _search(self, queries, k=None):
        batches = self._open.pop(threading.get_ident(), None)
        if batches is not None:
            self.runs.append((batches, k))
        return self.search(queries, k)

    def close(self) -> None:
        self.retriever.encode, self.retriever.search = self.encode, self.search

    @staticmethod
    def key(ids) -> bytes:
        """A request's token ids (a built query's ``conv_qp``) as a key."""
        return np.asarray(ids, np.int64).tobytes()

    def against_padded(self, what: str) -> float:
        """Each logged call's batches encoded again, packed as served and
        through the padded layout (``encoder._encode`` without a plan) on
        the retriever's float32 tower: the packed rows' scores against the
        padded rows within 1e-6 of the top score (an int8 tower would be
        bit for bit; these are float32).  Returns the largest error."""
        from haconvdr_torch.models.encoder import _encode

        tower = self.retriever.encoder
        check(tower.cfg.dtype == "float32", f"{what}: the padded check takes a float32 tower")
        errs = []
        with torch.inference_mode():
            for batches, _ in self.runs:
                packed = torch.from_numpy(self.encode(batches)).to(tower.device)
                padded = torch.cat([_encode(
                    [tower], torch.from_numpy(b["conv_qp"]).to(tower.device),
                    torch.from_numpy(b["conv_qp_mask"]).to(tower.device))[
                        torch.from_numpy(np.asarray(b["valid"], bool)).to(tower.device)]
                    for b in batches])
                ref = padded @ padded.T
                errs.append(float((packed @ padded.T - ref).abs().max() / ref.abs().max()))
        worst = max(errs)
        check(worst <= 1e-6, f"{what}: a served dispatch's packed scores are {worst:.3g} of the "
              "top score from the padded layout's (limit 1e-6)")
        print(f"{what}: {len(errs)} served dispatches encoded packed and padded: scores within "
              f"{worst:.3e} of the top score (limit 1e-6)")
        return worst

    def rerun(self):
        """{``key`` of a request's ids: [(embedding, hits), ...]}: each logged
        call run again, hits as (id, score) of every rank."""
        from collections import defaultdict

        out = defaultdict(list)
        for batches, k in self.runs:
            q = self.encode(batches)
            sc, ids = self.search(q, k)
            rows = [x for b in batches for x, v in zip(b["conv_qp"], b["valid"]) if v]
            for j, x in enumerate(rows):
                out[self.key(x)].append(
                    (q[j], [(int(i), float(y)) for i, y in zip(ids[j], sc[j])]))
        return out


def check_window_routes(counts, search_qs, dtype, what: str, card: str) -> None:
    """Every search ran row 3 once, on the route window_route names for
    its Q: the per-route launch counts equal those the searches' Q give,
    and route A (single requests) and the dtype's tiled route both ran."""
    from collections import Counter

    from haconvdr_torch.ops import topk_v4 as v4

    want = Counter(v4.window_route(Q, dtype, DIM) for Q in search_qs)
    got = {r: counts["topk_v4"]["window_" + r] for r in ("a", "b", "c")}
    check(all(n == want.get(r, 0) for r, n in got.items()),
          f"{what}: window launches by route {got}, the searches' Q give {dict(want)}")
    tiled = "c" if dtype == torch.int8 else "b"
    check(got["a"] > 0 and got[tiled] > 0, f"{what}: routes a and {tiled} did not both run")
    print(f"{what}: window routes {got} over {len(search_qs)} searches, Q "
          f"{sorted(set(search_qs))} [{card}]")


def print_search_ms(what: str, search_qs, search_ms, card: str) -> None:
    """Host ms of the index searches of a serving phase (query embeddings
    in, ids out): the single requests' (Q 1) and each batched one's."""
    one = [ms for Q, ms in zip(search_qs, search_ms) if Q == 1]
    batched = [(Q, round(ms, 2)) for Q, ms in zip(search_qs, search_ms) if Q > 1]
    print(f"{what} search: Q 1 median {float(np.median(one)):.2f} ms of {[round(x, 2) for x in one]}"
          f"; batched (Q, ms) {batched} [{card}]")


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

def attention_row(qkv, lengths, config: str, rows, head_split: bool = False) -> None:
    """Row 1 on qkv [B, L, 3H] with prefix masks of ``lengths``: the kernel
    against its twin (float32 within 1e-4, bfloat16 within 2**-6 + 2**-8
    |ref|), its time, the twin's, SDPA's and the bound.  The float32 route
    runs each product as three TF32 products (3xTF32), so its operations
    are three times the products' at the TF32 peak.  ``head_split``: the
    [B, H, L, d] wrapper (fused_attention) on the heads of qkv instead,
    which must launch the kernel once and no plain twin (counts zeroed
    just before) and equal the kernel on the fused projection bit for
    bit."""
    from haconvdr_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_qkv,
        fused_attention_qkv_plain,
    )

    B, L, _ = qkv.shape
    mask = torch.from_numpy(
        (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)).to(qkv.device)
    q, k, v, bias = sdpa_operands(qkv, mask)
    if head_split:
        def call():
            return fused_attention(q, k, v, mask)
        zero_counts()
        out = call().transpose(1, 2).reshape(B, L, DIM)
        torch.cuda.synchronize()
        c = read_counts()
        check_counts(c, [("fused_attention", "kernel")], f"attention {config}")
        check(c["fused_attention"]["kernel"] == 1, f"attention {config}: "
              f"{c['fused_attention']['kernel']} launches for one call")
        check(torch.equal(out, fused_attention_qkv(qkv, mask, 12)),
              f"attention {config}: differs from the kernel on the fused projection")
    else:
        def call():
            return fused_attention_qkv(qkv, mask, 12)
        out = call()
        torch.cuda.synchronize()
    ref = fused_attention_qkv_plain(qkv, mask, 12)
    diff = (out.float() - ref.float()).abs()
    if qkv.dtype == torch.float32:
        check(float(diff.max()) <= 1e-4, f"attention {config}: {float(diff.max())}")
    else:
        check(bool((diff <= 2.0**-6 + 2.0**-8 * ref.float().abs()).all()),
              f"attention {config}: beyond one bf16 ulp ({float(diff.max())})")
    ms = cuda_ms(call, reps=ATTN_REPS)
    pms = cuda_ms(lambda: fused_attention_qkv_plain(qkv, mask, 12), reps=10)
    lms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
                  reps=ATTN_REPS)
    flops, peak = attention_flops(lengths, L, DIM, 2), PEAK_OF[str(qkv.dtype).split(".")[1]]
    if peak == "f32":
        flops, peak = 3 * flops, "tf32"
    rows.append(dict(kernel="fused_attention", config=config, max_abs_err=float(diff.max()),
                     ms=ms, plain_ms=pms, library_ms=lms, shape=list(qkv.shape),
                     **bound_row(flops, B * L * (4 * DIM * qkv.element_size() + 4), peak)))


def kernels_v3_attention(dev, g, rng, passages_f32, codes, scale, rows):
    from haconvdr_torch.ops.fused_topk import fused_topk_block, fused_topk_block_plain

    # -- attention at B=8, L=512, H=768, 12 heads, random padding lengths
    lengths = rng.integers(1, ATTN_L + 1, ATTN_B)
    lengths[0] = ATTN_L
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        qkv = torch.randn(ATTN_B, ATTN_L, 3 * DIM, device=dev, generator=g).to(dt)
        attention_row(qkv, lengths, name, rows)
        attention_row(qkv, lengths, f"head-split {name}", rows, head_split=True)
        del qkv
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
            # the plain twins of the 2.5M-row searches: one timed call, warm
            # from the check (~70-80 ms a call)
            pms = cuda_ms(
                lambda: fused_topk_block_plain(qq, p, n_valid, TOP_K, init_scores=init), 1, 0
            )
            rows.append(dict(kernel="fused_topk", config=tag[6:], max_abs_err=err, ms=ms,
                             plain_ms=pms, library_ms=None, shape=[Q_KERNEL, N_ROWS, DIM, TOP_K],
                             **chain_bound(p, Q_KERNEL, n_valid, name, Q_KERNEL * TOP_K * 8)))
        del p
    del extra
    torch.cuda.empty_cache()


def kernels_v3_queries(seed: int, dev, passages_f32, codes, scale, rows) -> None:
    """Row 2 (the v3 kernel) at each Q of ROW2_QS per mode, unseeded and
    seeded: against its plain twin, in device ms (calls queued behind a
    spin, device_ms), its plain twin's ms (one warm call), its bound at
    the passages' type and at the fmaf chain's f32 rate; its own
    generator, so the other rows see the data they always saw."""
    from haconvdr_torch.ops.fused_topk import fused_topk_block, fused_topk_block_plain

    g = torch.Generator(device=dev).manual_seed(seed + 13)
    n_valid = N_ROWS - N_PAD
    q_all = torch.randn(max(ROW2_QS), DIM, device=dev, generator=g)
    extra = torch.randn(100_000, DIM, device=dev, generator=g)
    seeds = torch.topk(q_all @ extra.T, TOP_K, dim=1).values
    del extra
    for name in ("float32", "bfloat16", "int8"):
        if name == "bfloat16":
            p = passages_f32.to(torch.bfloat16)
        else:
            p = codes if name == "int8" else passages_f32
        for Q in ROW2_QS:
            q = q_all[:Q] * scale if name == "int8" else q_all[:Q]
            for seeded in (False, True):
                init = seeds[:Q].contiguous() if seeded else None
                tag = f"{name}, Q {Q}{', seeded' if seeded else ''}"
                s, i = fused_topk_block(q, p, n_valid, TOP_K, init_scores=init)
                torch.cuda.synchronize()
                rs, ri = fused_topk_block_plain(q, p, n_valid, TOP_K, init_scores=init)
                err = compare_topk(s, i, rs, ri, f"top-k {tag}")
                check(int(i.max()) < n_valid, f"top-k {tag}: a row past n_valid surfaced")
                if not seeded and Q in PRESAMPLE_QS:
                    presample_row(name, q, p, n_valid, s, i, rows)
                rows.append(dict(
                    kernel="fused_topk", config=tag, max_abs_err=err,
                    ms=device_ms(lambda: fused_topk_block(q, p, n_valid, TOP_K,
                                                          init_scores=init), 5 if Q <= 64 else 3),
                    plain_ms=cuda_ms(lambda: fused_topk_block_plain(
                        q, p, n_valid, TOP_K, init_scores=init), 1, 0),
                    library_ms=None, shape=[Q, N_ROWS, DIM, TOP_K],
                    **chain_bound(p, Q, n_valid, name, Q * TOP_K * 8)))
                del s, i, rs, ri
        del p
    del q_all, seeds
    torch.cuda.empty_cache()


def presample_row(name: str, q, p, n_valid: int, s, i, rows) -> None:
    """Row 2 with ``presample=-1`` (JAX's auto pre-pass: 16 rows of every
    1,024-row tile scored by torch.matmul, the kernel seeded with the
    threshold alone on its seeded grid): one kernel launch and no plain
    twin (counts zeroed just before), the unseeded kernel's answers (s, i)
    bit for bit with no id -1, and its plain twin's within the top-k rule;
    device ms (the pre-pass included) and the twin's ms."""
    from haconvdr_torch.ops.fused_topk import fused_topk_block, fused_topk_block_plain

    Q = q.shape[0]
    tag = f"{name}, Q {Q}, presample"
    zero_counts()
    ps, pi = fused_topk_block(q, p, n_valid, TOP_K, presample=-1)
    torch.cuda.synchronize()
    c = read_counts()
    check_counts(c, [("fused_topk", "kernel")], f"top-k {tag}")
    check(c["fused_topk"]["kernel"] == 1, f"top-k {tag}: {c['fused_topk']['kernel']} launches")
    check(torch.equal(ps, s) and torch.equal(pi, i), f"top-k {tag}: differs from the unseeded "
          "kernel")
    check(not bool((pi < 0).any()), f"top-k {tag}: an id -1 surfaced")
    rs, ri = fused_topk_block_plain(q, p, n_valid, TOP_K, presample=-1)
    err = compare_topk(ps, pi, rs, ri, f"top-k {tag}")
    rows.append(dict(
        kernel="fused_topk", config=tag, max_abs_err=err,
        ms=device_ms(lambda: fused_topk_block(q, p, n_valid, TOP_K, presample=-1),
                     5 if Q <= 64 else 3),
        plain_ms=cuda_ms(lambda: fused_topk_block_plain(q, p, n_valid, TOP_K, presample=-1),
                         1, 0),
        library_ms=None, shape=[Q, N_ROWS, DIM, TOP_K],
        **chain_bound(p, Q, n_valid, name, Q * TOP_K * 8)))


def kernels_attention_frozen(seed: int, dev, rows):
    """Row 1 at the frozen passage towers' shape (B 64, L 384, passage
    lengths 32-384): bf16 as phase 9's int8 towers run it, then f32 on the
    same values as phase 11's f32 towers run it; its own generators, so
    the other rows see the data they always saw."""
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    lengths = np.random.default_rng(seed + 3).integers(TRAIN_PLEN // 12, TRAIN_PLEN + 1, TRAIN_B)
    qkv = torch.randn(TRAIN_B, TRAIN_PLEN, 3 * DIM, device=dev, generator=g)
    attention_row(qkv.to(torch.bfloat16), lengths, ROW1_FROZEN, rows)
    attention_row(qkv, lengths, ROW1_FROZEN_F32, rows)
    del qkv
    torch.cuda.empty_cache()


def print_redesigned(rows, card: str) -> None:
    """One line per row of a redesigned route: rows 1, 11 and 12, the bf16
    routes on the tensor cores and the f32 routes in 3xTF32, and rows 4
    and 6 (the split select) per panel.  Each gives the kernel's time, its
    library call's (SDPA or torch.topk), the bound and the kernel's time
    over the library call's; row 12 against SDPA's backward alone, then
    its forward + backward against SDPA's forward + backward.  Rows 8-10
    per case and row 7 (k 100 in float32 and bfloat16, k 129 and 1,024 in
    float32): ms (row 7: device), plain ms, library ms (or none), bound and
    ms / bound.  Row 5 (the rescore kernel) per mode at Q 1, 8 and 256:
    device ms, the bound, ms / bound and the plain twin's ms.  Row 3 (the window kernel) per mode at Q 1, 64
    and 256: device ms, its route, the bound at the route's rate, ms / that
    bound and the plain twin's ms.  Row 2 (the v3 kernel) per mode, Q of
    ROW2_QS and seed: device ms, plain ms, the bound at the passages' type
    and ms / bound, then the bound at the fmaf chain's f32 rate and ms /
    that bound."""
    for r in rows:
        if r["kernel"] == "fused_topk" and ", Q " in r["config"]:
            print(f"redesigned fused_topk [{r['config']}]: {r['ms']:.4f} ms device, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"ms / bound {r['ms'] / r['bound_ms']:.2f}; at the chain's f32 rate "
                  f"{r['chain_bound_ms']:.4f} ms, ms / that {r['ms'] / r['chain_bound_ms']:.2f} "
                  f"[{card}]")
            continue
        if r["kernel"] == "window_top2":
            mode, _, q = r["config"].partition(", Q ")
            ms = r.get("device_ms", r["ms"])
            print(f"redesigned window_top2 [{mode}, Q {q or Q_KERNEL}]: {ms:.4f} ms device, "
                  f"route {r['route']}, bound at the route's rate {r['route_bound_ms']:.4f} ms, "
                  f"x bound {ms / r['route_bound_ms']:.2f}; plain {r['plain_ms']:.4f} ms [{card}]")
            continue
        if r["kernel"] in ("select_topk_t", "select_topk"):
            C, Q, k = r["shape"]
            print(f"redesigned {r['kernel']} [{r['config']}] [{C}, {Q}] k {k}: {r['ms']:.4f} ms "
                  f"device (one split {r['one_split_ms']:.4f}; events, host included, "
                  f"{r['events_ms']:.4f}), torch.topk {r['library_ms']:.4f} ms device, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}), ms / torch.topk "
                  f"{r['ms'] / r['library_ms']:.2f} [{card}]")
            continue
        if r["kernel"] == "rescore_windows":
            mode, _, q = r["config"].partition(", Q ")
            print(f"redesigned rescore_windows [{mode}, Q {q or Q_KERNEL}] {r['shape']}: "
                  f"{r['ms']:.4f} ms device, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                  f"ms / bound {r['ms'] / r['bound_ms']:.2f}; plain {r['plain_ms']:.4f} ms "
                  f"[{card}]")
            continue
        if r["kernel"] in ("fused_ln", "fused_ln_quant", "fused_mlp", "topk_stream"):
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            print(f"redesigned {r['kernel']} [{r['config']}] {r['shape']}: {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}), ms / bound {r['ms'] / r['bound_ms']:.2f} [{card}]")
            continue
        if r["kernel"] not in ("fused_attention", "flash_attention_fwd", "flash_attention_bwd"):
            continue
        sdpa = "SDPA backward" if r["kernel"] == "flash_attention_bwd" else "SDPA"
        line = (f"redesigned {r['kernel']} [{r['config']}]: {r['ms']:.4f} ms, {sdpa} "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                f"ms / SDPA {r['ms'] / r['library_ms']:.2f}")
        if r["kernel"] == "flash_attention_bwd":
            line += (f"; forward + backward {r['fwd_plus_bwd_ms']:.4f} ms, SDPA forward + "
                     f"backward {r['library_fwd_bwd_ms']:.4f} ms, ratio "
                     f"{r['fwd_plus_bwd_ms'] / r['library_fwd_bwd_ms']:.2f}")
        print(f"{line} [{card}]")


def kernels_stream(dev, g, passages_f32, rows):
    """Row 7: the streaming top-k over the first N_STREAM rows (a view),
    float32 and bfloat16, against its plain twin and, bit for bit, against
    the unseeded v3 kernel on the same rows (one fmaf chain in both)."""
    from haconvdr_torch.ops import topk_stream as ts
    from haconvdr_torch.ops.fused_topk import fused_topk_block

    q = torch.randn(Q_KERNEL, DIM, device=dev, generator=g)
    n_valid = N_STREAM - N_PAD
    for name in ("float32", "bfloat16"):
        p = passages_f32[:N_STREAM]
        if name == "bfloat16":
            p = p.to(torch.bfloat16)
        s, i = ts.topk_block_v2(q, p, n_valid, TOP_K)
        torch.cuda.synchronize()
        rs, ri = ts.topk_block_v2_plain(q, p, n_valid, TOP_K)
        err = compare_topk(s, i, rs, ri, f"topk_stream {name}")
        check(int(i.max()) < n_valid, f"topk_stream {name}: a row past n_valid surfaced")
        vs, vi = fused_topk_block(q, p, n_valid, TOP_K)
        check(torch.equal(s, vs) and torch.equal(i, vi),
              f"topk_stream {name}: not bit-equal to the unseeded v3 kernel")
        rows.append(dict(kernel="topk_stream", config=name, max_abs_err=err,
                         ms=device_ms(lambda: ts.topk_block_v2(q, p, n_valid, TOP_K), 3),
                         # one warm call each
                         plain_ms=cuda_ms(
                             lambda: ts.topk_block_v2_plain(q, p, n_valid, TOP_K), 1, 0),
                         v3_ms=cuda_ms(lambda: fused_topk_block(q, p, n_valid, TOP_K), 1, 0),
                         bit_equal_v3=True, library_ms=None,
                         shape=[Q_KERNEL, N_STREAM, DIM, TOP_K],
                         **search_bound(p, Q_KERNEL, n_valid, name, Q_KERNEL * TOP_K * 8)))
        del p, s, i, rs, ri, vs, vi
    # k past 128 (the buffers in device memory, the wide merge), float32:
    # against the twin only (the v3 kernel takes k <= 128)
    p = passages_f32[:N_STREAM]
    for k in STREAM_WIDE_K:
        s, i = ts.topk_block_v2(q, p, n_valid, k)
        torch.cuda.synchronize()
        rs, ri = ts.topk_block_v2_plain(q, p, n_valid, k)
        err = compare_topk(s, i, rs, ri, f"topk_stream float32 k {k}")
        check(int(i.max()) < n_valid, f"topk_stream k {k}: a row past n_valid surfaced")
        rows.append(dict(kernel="topk_stream", config=f"float32, k {k}", max_abs_err=err,
                         ms=device_ms(lambda: ts.topk_block_v2(q, p, n_valid, k), 3),
                         plain_ms=cuda_ms(lambda: ts.topk_block_v2_plain(q, p, n_valid, k), 1, 0),
                         library_ms=None, shape=[Q_KERNEL, N_STREAM, DIM, k],
                         **search_bound(p, Q_KERNEL, n_valid, "float32", Q_KERNEL * k * 8)))
        del s, i, rs, ri
    del p
    torch.cuda.empty_cache()


def window_bound(route: str, name: str, Q: int, p, n_valid: int) -> float:
    """Row 3's least time on its route (ms): the passages read once over
    the memory rate, or 2 Q n_valid D operations at the route's rate."""
    t_bytes = p.numel() * p.element_size() / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, 2.0 * Q * n_valid * DIM / WINDOW_RATE[(route, name)] * 1e3)


def compare_window(got, ref, exact: bool, what: str) -> float:
    """Window panels (v1, a1, v2) against the plain twin's: the same -inf
    slots, v1 and v2 within the float tolerance (int8: equal), a1 equal
    where v1 and v2 are separated; returns max |diff|."""
    (v1, a1, v2), (r1, ra, r2) = got, ref
    err = 0.0
    for g_, r_, name in ((v1, r1, "v1"), (v2, r2, "v2")):
        fin = torch.isfinite(r_)
        check(torch.equal(fin, torch.isfinite(g_)), f"window {what}: {name} -inf differs")
        d = (g_[fin] - r_[fin]).abs()
        check(bool((d <= (0.0 if exact else 1e-4) * r_[fin].abs()).all()),
              f"window {what}: {name} beyond tolerance ({float(d.max())})")
        err = max(err, float(d.max()) if d.numel() else 0.0)
    gap = torch.isfinite(r1) & ((r1 - r2) > (0.0 if exact else 1e-5) * r1.abs())
    check(torch.equal(a1[gap], ra[gap]), f"window {what}: a1 differs at separated v1/v2")
    return err


def check_flagged_rescore(q, p, panels, n_valid: int, sw: int, budget: int, what: str) -> None:
    """rescore_windows on each query's own flagged windows (v2 at or above
    its k-th window max; the largest ``budget``, as the path's second
    select takes them): the rows' max, its lowest row and the second max
    equal the panels bit for bit."""
    from haconvdr_torch.ops import topk_v4 as v4

    v1, a1, v2 = panels
    W, Q = v1.shape
    v_k = torch.topk(v1, TOP_K, dim=0).values[TOP_K - 1]
    flag = torch.where((v2 >= v_k[None, :]) & torch.isfinite(v2), v2, float("-inf"))
    win = torch.topk(flag, budget, dim=0).indices.T.to(torch.int32).contiguous()
    resc = v4.rescore_windows(p, q, win, sw, n_valid).view(Q, budget, sw)
    qi = torch.arange(Q, device=p.device)[:, None].expand(-1, budget)
    w = win.long()
    top = resc.amax(2)
    pos = torch.where(resc == top[..., None], torch.arange(sw, device=p.device), sw).amin(2)
    second = resc.scatter(2, pos[..., None], float("-inf")).amax(2)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    check(torch.equal(bits(top), bits(v1[w, qi])) and torch.equal(pos + w * sw, a1[w, qi].long())
          and torch.equal(bits(second), bits(v2[w, qi])),
          f"window {what}: differs from rescore_windows on its flagged windows")


def window_row(name: str, q, p, n_valid: int, sw: int, budget: int, rows) -> None:
    """Row 3 at Q = q.shape[0] (WINDOW_QS) on the route window_route names:
    against the plain twin, bit for bit against rescore_windows on its own
    flagged windows, then timed in device ms."""
    from haconvdr_torch.ops import topk_v4 as v4

    Q = q.shape[0]
    route = v4.window_route(Q, p.dtype, DIM)
    got = v4.window_top2(q, p, n_valid, sw)
    torch.cuda.synchronize()
    err = compare_window(got, v4.window_top2_plain(q, p, n_valid, sw), name == "int8",
                         f"{name} Q {Q}")
    check_flagged_rescore(q, p, got, n_valid, sw, budget, f"{name} Q {Q}")
    rows.append(dict(kernel="window_top2", config=f"{name}, Q {Q}", route=route,
                     max_abs_err=err, ms=device_ms(lambda: v4.window_top2(q, p, n_valid, sw)),
                     plain_ms=cuda_ms(lambda: v4.window_top2_plain(q, p, n_valid, sw), 1, 0),
                     library_ms=None, shape=[Q, N_ROWS, DIM, sw],
                     route_bound_ms=window_bound(route, name, Q, p, n_valid),
                     **search_bound(p, Q, n_valid, name, 3 * got[0].numel() * 4)))


def rescore_row(name: str, q, p, win, panels, n_valid: int, sw: int, rows) -> None:
    """Row 5 at Q = q.shape[0] (RESCORE_QS) on win [Q, 8] (7 windows and an
    empty slot a query): against the plain twin, bit for bit against the
    window kernel's panels of the same queries (the rows' max, its row and
    the second max), the empty slot -inf; then timed in device ms beside
    its bound (the distinct windows read once) and the plain twin."""
    from haconvdr_torch.ops import topk_v4 as v4

    v1, a1, v2 = panels
    Q, B = win.shape
    exact = name == "int8"
    tag = name if Q == Q_KERNEL else f"{name}, Q {Q}"
    resc = v4.rescore_windows(p, q, win, sw, n_valid)
    torch.cuda.synchronize()
    ref = v4.rescore_windows_plain(p, q, win, sw, n_valid)
    fin = torch.isfinite(ref)
    check(torch.equal(fin, torch.isfinite(resc)), f"rescore {tag}: -inf differs")
    d = (resc[fin] - ref[fin]).abs()
    check(bool((d <= (0.0 if exact else 1e-4) * ref[fin].abs() + (0 if exact else 1e-4)).all()),
          f"rescore {tag}: beyond tolerance ({float(d.max())})")
    r3 = resc.view(Q, B, sw)[:, : B - 1]
    qi = torch.arange(Q, device=p.device)[:, None].expand(-1, B - 1)
    w = win[:, : B - 1].long()
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    top = r3.amax(2)
    pos = torch.where(r3 == top[..., None], torch.arange(sw, device=p.device), sw).amin(2)
    check(torch.equal(bits(top), bits(v1[w, qi])), f"rescore {tag}: max != window v1")
    check(torch.equal(pos + w * sw, a1[w, qi].long()), f"rescore {tag}: its row != window a1")
    check(torch.equal(bits(r3.scatter(2, pos[..., None], float("-inf")).amax(2)),
                      bits(v2[w, qi])), f"rescore {tag}: second max != window v2")
    check(bool(torch.isneginf(resc.view(Q, B, sw)[:, -1]).all()),
          f"rescore {tag}: empty slot not -inf")
    # the distinct windows this run's queries name, each read once
    n_win = int(torch.unique(win[win >= 0]).numel())
    rows.append(dict(kernel="rescore_windows", config=tag, max_abs_err=float(d.max()),
                     ms=device_ms(lambda: v4.rescore_windows(p, q, win, sw, n_valid)),
                     plain_ms=cuda_ms(lambda: v4.rescore_windows_plain(p, q, win, sw, n_valid), 3),
                     library_ms=None, shape=[Q, B, sw, DIM],
                     **bound_row(2.0 * Q * (B - 1) * sw * DIM,
                                 n_win * sw * DIM * p.element_size() + q.numel()
                                 * q.element_size() + win.numel() * 4 + resc.numel() * 4,
                                 PEAK_OF[name])))


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
        # -- window top-2: at Q_KERNEL, then at WINDOW_QS (routes by Q)
        v1, a1, v2 = v4.window_top2(q, p, n_valid, sw)
        torch.cuda.synchronize()
        r1, ra, r2 = v4.window_top2_plain(q, p, n_valid, sw)
        err = compare_window((v1, a1, v2), (r1, ra, r2), exact, name)
        route = v4.window_route(Q_KERNEL, p.dtype, DIM)
        rows.append(dict(kernel="window_top2", config=name, route=route, max_abs_err=err,
                         ms=cuda_ms(lambda: v4.window_top2(q, p, n_valid, sw), 3),
                         device_ms=device_ms(lambda: v4.window_top2(q, p, n_valid, sw), 5),
                         plain_ms=cuda_ms(
                             lambda: v4.window_top2_plain(q, p, n_valid, sw), 1, 0),
                         library_ms=None, shape=[Q_KERNEL, N_ROWS, DIM, sw],
                         route_bound_ms=window_bound(route, name, Q_KERNEL, p, n_valid),
                         **search_bound(p, Q_KERNEL, n_valid, name, 3 * v1.numel() * 4)))
        for Qw in WINDOW_QS:
            window_row(name, q[:Qw].contiguous(), p, n_valid, sw, budget, rows)
        if name == "float32":  # context: the score product alone, as one PyTorch call
            mm_ms = device_ms(lambda: torch.matmul(q, p.T), 3)
            print(f"context: torch.matmul float32 [{Q_KERNEL}, {DIM}] x [{DIM}, {N_ROWS}] "
                  f"(scores only, no window triples) {mm_ms:.4f} ms device [{card_line()}]")
        # -- rescore: 7 random windows and an empty slot a query, at Q 1, 8 and
        # Q_KERNEL, bit for bit against the window kernel's panels
        W = v1.shape[0]
        win = torch.randint(0, W, (Q_KERNEL, 8), device=dev, generator=g, dtype=torch.int32)
        win[:, -1] = -1  # an empty slot
        for Qr in RESCORE_QS:
            rescore_row(name, q[:Qr].contiguous(), p, win[:Qr].contiguous(), (v1, a1, v2),
                        n_valid, sw, rows)
        if name == "float32":  # select panels from real window scores
            panels = select_panels(v1, r2, sw, budget)
        del v1, a1, v2, r1, ra, r2
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
                             lambda: fused_topk_block_plain(qf, p, n_valid, TOP_K), 1, 0),
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
    # -- select: both layouts at Q 256, 7 and 1, on the path's own panels
    # (v1T cold at k 100; the flagged second maxima at k = budget), cold at
    # the path's pool and warm (with a floor) at a pool wide enough for
    # warm_floor; a floor must change no answer
    for temp, (panel, k, warm) in panels.items():
        for Q in SELECT_QS:
            kernels_select(dev, g, temp, panel[:, :Q].contiguous(), k, warm, rows)
    torch.cuda.empty_cache()


def select_panels(v1, v2, sw: int, budget: int) -> dict:
    """The select kernel's panels at Q_KERNEL, from real window scores:
    name -> ([C, Q] scores, k, warm)."""
    from haconvdr_torch.ops import topk_v4 as v4

    W = v1.shape[0]
    v_k = v4.select_plain(v1.T, TOP_K)[0][:, TOP_K - 1]  # what the path's first select gives
    flag = (v2 >= v_k[None, :]) & torch.isfinite(v2)
    return {
        # the path's pool [W + 8 sw, Q]: 93 segments of 128 rows, fewer
        # than k, so the path's selects run cold
        "cold": (torch.cat([v1, v2[: 8 * sw]]).contiguous(), TOP_K, False),
        # the pool of a 1.7M-row float32 search (sw 128, budget 4):
        # [13,282 + 4 * 128, Q], 108 segments, so a floor applies
        "warm": (torch.cat([v1, v2[: WARM_POOL - W]]).contiguous(), TOP_K, True),
        # the path's first select: the window maxima v1T [W, Q], cold
        "path-v1": (v1.contiguous(), TOP_K, False),
        # its second: the flagged second maxima, nearly all -inf, k = budget
        "path-flag": (torch.where(flag, v2, float("-inf")).contiguous(), budget, False),
    }


def kernels_select(dev, g, temp: str, panel, k: int, warm: bool, rows) -> None:
    """Rows 4 and 6 on one [C, Q] panel: select_topk_t on it, select_topk
    on its [Q, C] copy with a random permutation as tie-break ids; each bit
    for bit against the plain twin and the cold plain twin, then timed
    beside torch.topk on the same view."""
    from haconvdr_torch.ops import topk_v4 as v4

    C, Q = panel.shape
    fl = v4.warm_floor(panel, k) if warm else None
    if warm:
        check(fl is not None, "warm select: warm_floor gave no floor")
        admitted = float((panel > fl[None, :]).sum(0).double().mean())
        print(f"warm select Q {Q}: the floor admits {admitted:.1f} of {C} entries per query")
    ids = torch.randperm(C, device=dev, generator=g).to(torch.int32)
    rowmajor = panel.T.contiguous()  # [Q, C]; at Q = 1 the view of panel itself
    rowmajor_ids = torch.empty_like(rowmajor, dtype=torch.int32).copy_(ids[None, :].expand(Q, -1))
    cases = (  # (name, kernel(floor, splits), plain twin(floor), library call, id bytes)
        ("select_topk_t", lambda f, sp=None: v4._select(panel.T, k, f, None, "select_t", sp),
         lambda f: v4.select_plain(panel.T, k, f), lambda: torch.topk(panel, k, dim=0), 0),
        ("select_topk", lambda f, sp=None: v4._select(rowmajor, k, f, rowmajor_ids, "select", sp),
         lambda f: v4.select_plain(rowmajor, k, f, rowmajor_ids),
         lambda: torch.topk(rowmajor, k, dim=1), rowmajor_ids.numel() * 4),
    )
    config = temp if Q == Q_KERNEL else f"{temp}, Q {Q}"
    for kname, run, plain, library, id_bytes in cases:
        got, ref, ref_cold = run(fl), plain(fl), plain(None)
        # the single-launch route (one split) on the same panel
        one = run(fl, 1)
        torch.cuda.synchronize()
        for have, want, what in ((got, ref, "the plain twin"), (got, ref_cold, "the cold plain twin"),
                                 (one, ref, "the plain twin (one split)")):
            check(torch.equal(have[0], want[0]) and torch.equal(have[1], want[1]),
                  f"{kname} {config}: differs from {what}")
        # a selection reads each score once: bytes-bound.  Device time
        # (device_ms): back to back, a call's host time (~0.04-0.09 ms)
        # exceeds its kernels' at small Q, and plain CUDA events would time
        # the host; events_ms is that host-inclusive time
        row = dict(kernel=kname, config=config, max_abs_err=0.0,
                   ms=device_ms(lambda: run(fl)), plain_ms=cuda_ms(lambda: plain(fl), 5),
                   library_ms=device_ms(library), shape=[C, Q, k],
                   one_split_ms=device_ms(lambda: run(fl, 1)),
                   events_ms=cuda_ms(lambda: run(fl), SELECT_REPS),
                   **bound_row(panel.numel(), panel.numel() * 4 + id_bytes + Q * k * 8, "f32"))
        if warm:  # the same panel without the floor
            row["cold_ms"] = device_ms(lambda: run(None))
        rows.append(row)


def device_ms(fn, reps: int = SELECT_REPS) -> float:
    """Device time of one call of ``fn``: ``reps`` calls queued behind a
    spin of the card (torch.cuda._sleep), so that it runs them back to
    back however long the host takes to enqueue them, timed by CUDA events
    around the calls.  The spin is lengthened until the host has enqueued
    every call before the card reaches the first."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host could not enqueue the calls ahead of the card")


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
    # row 8 off the compile-time width: the generic kernel, H 256
    x256 = xb[:, :256].contiguous()
    l256, b256 = lns[:256].contiguous(), lnb[:256].contiguous()
    cases += (("fused_ln", "bf16, no residual, H 256",
               lambda: fl.fused_residual_ln(x256, None, l256, b256, eps),
               lambda: fl.fused_residual_ln_plain(x256, None, l256, b256, eps),
               lambda: F.layer_norm(x256, (256,), l256.to(bf), b256.to(bf), eps), R * 256 * 4),)
    for name, config, run, plain, library, nbytes in cases:
        got, ref = run(), plain()
        torch.cuda.synchronize()
        quant = name == "fused_ln_quant"
        y, ry = (got[0], ref[0]) if quant else (got, ref)
        d = (y.float() - ry.float()).abs()
        check(y.dtype == bf and bool((d <= 2.0**-7 * ry.float().abs() + 1e-5).all()),
              f"{name} {config}: y beyond one bf16 ulp ({float(d.max())})")
        width = y.shape[-1]
        row = dict(kernel=name, config=config, max_abs_err=float(d.max()),
                   y_diff_share=float((d > 0).float().mean()),
                   ms=cuda_ms(run, 5), plain_ms=cuda_ms(plain, 5),
                   library_ms=cuda_ms(library, 5) if library else None, shape=[R, width],
                   **bound_row(10.0 * R * width, nbytes + 2 * width * 4, "f32"))
        if quant:
            oq, os_ = quantize_rows(y)
            check(torch.equal(got[1], oq) and torch.equal(got[2], os_),
                  f"{name} {config}: yq, ys are not the quantization of the kernel's y")
            row["code_diff_share"] = codes_close(got[1], ref[1], f"{name} {config}")
        rows.append(row)
        del got, ref, y, ry, d
    del x256
    # -- the MLP block on an LN output carry, at the serving tower's rows (one
    # request of 512 tokens), the train-ref frozen towers' and corpus encode's
    x = fl.fused_residual_ln_plain(xb, r, lns, lnb, eps)
    del x32, xb, r
    xq, xs = quantize_rows(x)
    w1, s1 = int8_weight(g, dev, INTER, DIM)
    w2, s2 = int8_weight(g, dev, DIM, INTER)
    b1 = torch.randn(INTER, device=dev, generator=g) * 0.02
    b2 = torch.randn(DIM, device=dev, generator=g) * 0.02
    for n in MLP_ROWS:
        args = (x[:n], xq[:n], xs[:n], w1, s1, b1, w2, s2, b2, lns, lnb)
        run = lambda: fm.fused_mlp_block(*args, eps=eps)  # noqa: E731
        plain = lambda: fm.fused_mlp_block_plain(*args, eps=eps)  # noqa: E731
        (y, yq, ys), (ry, rq, _) = run(), plain()
        torch.cuda.synchronize()
        gy, wy = y.float(), ry.float()
        d = (gy - wy).abs()
        flips = float((d > 2.0**-6 * (1 + wy.abs())).float().mean())
        check(bool((d <= 2.0**-6 * wy.abs() + 0.07).all()) and flips < 2e-3,
              f"fused_mlp {n} rows: beyond the JAX test's bounds (max {float(d.max())}, "
              f"flips {flips})")
        oq, os_ = quantize_rows(y)
        check(torch.equal(yq, oq) and torch.equal(ys, os_),
              f"fused_mlp {n} rows: yq, ys are not the quantization of the kernel's y")
        rows.append(dict(kernel="fused_mlp", config=f"bf16, {n} rows", max_abs_err=float(d.max()),
                         y_diff_share=float((d > 0).float().mean()), flip_share=flips,
                         code_diff_share=codes_close(yq, rq, f"fused_mlp {n} rows"),
                         # device time: at 512 rows back-to-back events time the host
                         ms=device_ms(run), plain_ms=cuda_ms(plain, 3), library_ms=None,
                         shape=[n, DIM, INTER],
                         **bound_row(4.0 * n * DIM * INTER, n * DIM * 6 + n * 8
                                     + 2 * DIM * INTER * 1, "int8")))
        del args, y, yq, ys, ry, rq, gy, wy, d
    del x, xq, xs
    torch.cuda.empty_cache()


def bf16_ulp_of_max(ref: torch.Tensor) -> float:
    """One bf16 ulp of ref's largest magnitude (0 where ref is all zero)."""
    top = float(ref.float().abs().max())
    return float(2.0 ** (np.floor(np.log2(top)) - 7)) if top > 0 else 0.0


def check_dqkv_parts(got, want, what: str) -> None:
    """dQ, dK and dV of a bf16 dqkv [B, L, 3H] each within one bf16 ulp of
    its own largest magnitude."""
    for i, part in enumerate("QKV"):
        g, w = got[..., i * DIM:(i + 1) * DIM], want[..., i * DIM:(i + 1) * DIM]
        err, tol = float((g.float() - w.float()).abs().max()), bf16_ulp_of_max(w)
        check(err <= tol, f"{what}: d{part} {err} > {tol}")


def kernels_flash(dev, g, rng, rows):
    """Rows 11-12: the trained tower's attention forward and backward at
    B 8, L 512, H 768, 12 heads (float32 and bfloat16, dropout 0 and 0.1),
    at phase 9's own shape (B 64, query lengths 64-512, bfloat16, dropout
    0.1 and 0) and at phase 11's (the same in float32, dropout 0.1),
    against the plain twins on the same qkv, mask, output cotangent and
    seed words."""
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
    big = ragged_mask(TRAIN_B, TRAIN_QLEN // 8)
    cases.append((big, torch.bfloat16, 0.1, FLASH_MAIN))
    cases.append((big, torch.bfloat16, 0.0, f"bfloat16, drop 0.0, B {TRAIN_B}"))
    cases.append((big, torch.float32, 0.1, FLASH_F32))  # phase 11's route
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
        if dt == torch.bfloat16:
            check_dqkv_parts(x.grad, rdq, f"flash dqkv {config}")
        m32 = mask.contiguous()
        with torch.no_grad():
            _, stats = fa._fwd_kernel(qkv, m32, 12, seed, rate)
            fwd_ms = cuda_ms(lambda: fa._fwd_kernel(qkv, m32, 12, seed, rate), ATTN_REPS)
            bwd_ms = cuda_ms(lambda: fa._bwd_kernel(qkv, m32, stats, go, 12, seed, rate), 10)
            pf_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(qkv, mask, 12, seed, rate), 5)
            pb_ms = cuda_ms(
                lambda: fa.flash_attention_bwd_plain(qkv, mask, go, 12, seed, rate), 5)
            q, k, v, bias = sdpa_operands(qkv, mask)
            lf_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, dropout_p=rate), ATTN_REPS)
        xl = qkv.clone().requires_grad_(True)
        ql, kl, vl, _ = sdpa_operands(xl, mask)
        gh = go.view(B, ATTN_L, 12, 64).transpose(1, 2)
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, dropout_p=rate)
        lb_ms = cuda_ms(lambda: torch.autograd.grad(ol, xl, gh, retain_graph=True), 10)

        def library_fwd_bwd():
            F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, dropout_p=rate
                                           ).backward(gh)

        lfb_ms = cuda_ms(library_fwd_bwd, 10)
        # the f32 route runs each product as three TF32 products (3xTF32)
        isz, peak = qkv.element_size(), PEAK_OF[name]
        ops = 3 if peak == "f32" else 1
        peak = "tf32" if peak == "f32" else peak
        shape = [B, ATTN_L, 3 * DIM]
        rows.append(dict(kernel="flash_attention_fwd", config=config, max_abs_err=errs[0],
                         ms=fwd_ms, plain_ms=pf_ms, library_ms=lf_ms, shape=shape,
                         **bound_row(ops * attention_flops(lengths, ATTN_L, DIM, 2),
                                     B * ATTN_L * (4 * DIM * isz + 4), peak)))
        # the backward recomputes S (one L x L product) and forms dV,
        # dP, dQ and dK; its library figure is SDPA's backward alone (to
        # dqkv, through the same views), with SDPA forward + backward beside
        rows.append(dict(kernel="flash_attention_bwd", config=config, max_abs_err=errs[1],
                         ms=bwd_ms, plain_ms=pb_ms, library_ms=lb_ms,
                         fwd_plus_bwd_ms=fwd_ms + bwd_ms, library_fwd_bwd_ms=lfb_ms,
                         shape=shape,
                         **bound_row(ops * attention_flops(lengths, ATTN_L, DIM, 5),
                                     B * ATTN_L * (7 * DIM * isz + 4), peak)))
        del qkv, go, x, out, ref, rdq, stats, q, k, v, bias, xl, ql, kl, vl, gh, ol
    torch.cuda.empty_cache()


def phase_kernels(seed: int, dev, passages_f32, codes, scale):
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)
    rows = []
    kernels_v3_attention(dev, g, rng, passages_f32, codes, scale, rows)
    kernels_v3_queries(seed, dev, passages_f32, codes, scale, rows)
    kernels_v4(dev, g, passages_f32, codes, scale, rows)
    kernels_int8_tower(dev, g, rows)
    kernels_flash(dev, g, rng, rows)
    kernels_stream(dev, g, passages_f32, rows)
    kernels_attention_frozen(seed, dev, rows)
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
    search_qs, search_ms = [], []  # the Q of every index search, and its host ms
    search = retriever.index.search

    def recording_search(queries, k):
        search_qs.append(int(np.asarray(queries).shape[0]))
        t = time.perf_counter()
        out = search(queries, k)  # host arrays: synchronized
        search_ms.append((time.perf_counter() - t) * 1e3)
        return out

    retriever.index.search = recording_search
    zero_counts()
    got, metrics = serve(retriever, reqs[:N_BATCHED], reqs[N_BATCHED:])
    counts = read_counts()
    print("main path launch counts:", json.dumps(counts))
    check_counts(counts, [("fused_attention", "kernel"), ("topk_v4", "window"),
                          ("topk_v4", "select_t"), ("topk_v4", "select")], "main path")
    check_window_routes(counts, search_qs, torch.float32, "main path", card)
    print_search_ms("main path", search_qs, search_ms, card)
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
    embed_ms = []  # one batch of 64 requests through the f32 tower
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        retriever.embed(examples[:64])
        embed_ms.append((time.perf_counter() - t) * 1e3)
    print(f"f32 tower embed: B 64 in {float(np.median(embed_ms)):.2f} ms "
          f"(median of {embed_ms}) [{card}]")
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
    served = {k: v.detach().cpu().clone() for k, v in retriever.encoder.state_dict().items()}
    del retriever, ref_enc
    torch.cuda.empty_cache()
    return counts, metrics, got_q, served


def phase_int8_path(seed: int, dev, passages_f32, params, cfg, card: str):
    t0 = time.perf_counter()
    retriever = build_retriever(params, cfg, dev, passages_f32, None, store_dtype="int8")
    index = retriever.index
    print(f"int8 path: set up in {time.perf_counter() - t0:.1f} s (index {N_ROWS}x{DIM} int8, "
          f"{index.passages.numel() / 2**30:.2f} GiB quantized on the card)")
    calls, search_ms = [], []  # (query embeddings, answer) of every index search; host ms
    search = index.search

    def recording_search(queries, k):
        t = time.perf_counter()
        out = search(queries, k)  # host arrays: synchronized
        search_ms.append((time.perf_counter() - t) * 1e3)
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
    check_window_routes(counts, [q.shape[0] for q, _ in calls], torch.int8, "int8 path", card)
    print_search_ms("int8 path", [q.shape[0] for q, _ in calls], search_ms, card)
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
    launches (embeddings, then each attention residual), one MLP launch
    per layer, and two int8 dense launches a layer (QKV, the attention
    output) with the output dense's codes: 13, 12, 24 and 12 at 12 layers."""
    check(n_fwd > 0, f"{what}: no tower forward ran")
    check(counts["fused_ln"]["ln_quant"] == (1 + layers) * n_fwd
          and counts["fused_ln"]["ln"] == 0 and counts["fused_mlp"]["kernel"] == layers * n_fwd,
          f"{what}: {n_fwd} forwards launched LN-quant {counts['fused_ln']['ln_quant']} "
          f"and MLP {counts['fused_mlp']['kernel']} times, not {1 + layers} and {layers} each")
    dense = counts["int8_dense"]
    check(dense["dense"] == 2 * layers * n_fwd and dense["codes"] == layers * n_fwd,
          f"{what}: {n_fwd} forwards launched the int8 dense {dense['dense']} and its codes "
          f"{dense['codes']} times, not {2 * layers} and {layers} each")


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
    calls, search_ms = [], []  # (query embeddings, answer) of every index search; host ms
    search = index.search

    def recording_search(queries, k):
        t = time.perf_counter()
        out = search(queries, k)  # host arrays: synchronized
        search_ms.append((time.perf_counter() - t) * 1e3)
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
    print_search_ms("int8 tower", [q.shape[0] for q, _ in calls], search_ms, card)
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
    embed_ms = []  # one batch of the 64 concurrent requests through the tower
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        retriever.embed(examples[:N_BATCHED_INT8])
        embed_ms.append((time.perf_counter() - t) * 1e3)
    print(f"int8 tower embed: B {N_BATCHED_INT8} in {float(np.median(embed_ms)):.2f} ms "
          f"(median of {embed_ms}) [{card}]")
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
    return counts, metrics, dict(max_abs_err=err, min_cos=cos, f32_cos=cos_k, f32_cos_plain=cos_p,
                                 embed_ms=embed_ms)


def corpus_tokens(seed: int, vocab: int):
    """(ids [N_CORPUS, ENC_LEN] int32, lengths [N_CORPUS]) of phase 8's corpus:
    lengths 32-ENC_LEN, <s> ... </s>, padded with 0, from the seed."""
    rng = np.random.default_rng(seed + 3)
    lengths = rng.integers(32, ENC_LEN + 1, N_CORPUS).astype(np.int32)
    ids = rng.integers(3, vocab, (N_CORPUS, ENC_LEN)).astype(np.int32)
    ids[:, 0] = 0  # <s>
    ids[np.arange(N_CORPUS), lengths - 1] = 2  # </s>
    ids[np.arange(ENC_LEN)[None, :] >= lengths[:, None]] = 0  # the writer's padding
    return ids, lengths


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
    ids, lengths = corpus_tokens(seed, cfg.vocab_size)
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


def train_setup(seed: int, dev, cfg, tcfg, plain: bool = False, rng_seed=None, devices=None):
    """The train step on a mesh of ``devices`` (default one slot of
    ``dev``; ``dev`` must be the first), a fresh train state (dropout
    generator from ``rng_seed``, default ``seed``) and the frozen tower
    (``tcfg``'s frozen dtype); ``plain`` runs the trained tower's plain
    twins (the frozen tower always runs the kernels)."""
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.train.trainer import (
        build_frozen_encoder,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    opt = make_optimizer(tcfg, total_steps=100)
    step = make_train_step(make_mesh(devices=devices or [dev]), cfg, tcfg, opt)
    model = AnceEncoder.from_jax_params(init_params_numpy(cfg, seed), cfg, dev, plain=plain)
    frozen = build_frozen_encoder(init_params_numpy(cfg, seed + 1), cfg, tcfg, dev)
    return step, init_train_state(model, opt, seed=seed if rng_seed is None else rng_seed), frozen


def eval_loss(state, frozen, batch, tcfg, dev) -> float:
    """The batch's loss with dropout off, the query tower in eval mode."""
    from haconvdr_torch.train.trainer import batch_to_device, embed_batch, embeddings_loss

    b = batch_to_device(batch, dev)
    with torch.no_grad():
        e = embed_batch(state.model, frozen, b, tcfg, trainable=False, host_masks=batch)
        return float(embeddings_loss(e, b, tcfg))


def check_train_counts(counts, layers: int, n_frozen: int, n_micro: int, int8: bool = True,
                       what: str = "training") -> None:
    """Per micro step: flash fwd and bwd once a layer (remat "mlp" reruns
    no attention) and layers inference attention launches per frozen
    forward; an int8 bf16 frozen forward adds 1 + layers LayerNorm-quant
    and layers MLP launches, an f32 one none."""
    want = {("flash_attention", "fwd"): layers, ("flash_attention", "bwd"): layers,
            ("fused_attention", "kernel"): layers * n_frozen,
            ("fused_ln", "ln_quant"): (1 + layers) * n_frozen if int8 else 0,
            ("fused_ln", "ln"): 0, ("fused_mlp", "kernel"): layers * n_frozen if int8 else 0}
    for (mod, key), n in want.items():
        check(counts[mod][key] == n * n_micro,
              f"{what}: {mod} {key} launched {counts[mod][key]} times in {n_micro} micro "
              f"steps, not {n} each")
    check_counts(counts, list(want)[:3], what)


def profile_window(run, n: int):
    """Device time of ``n`` calls of ``run`` (one accumulation window)
    under torch.profiler, against that window's own wall time: (wall ms,
    device ms, device ms by the first 70 characters of a kernel's name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:70]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    dev_ms = sum(by_name.values())
    check(dev_ms > 0, "training: the profiler saw no device time")
    return wall_ms, dev_ms, by_name


def profiled_ms(fn, n: int):
    """(wall ms, device ms, device operations) per call of ``fn`` over ``n``
    calls after a warm-up, under torch.profiler.  The device ms sum the
    durations of the calls' kernels, copies and fills (one stream, so none
    overlap); the wall ms include the host's time to enqueue them and the
    profiler's own cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    check(dev_ms > 0, "profiled_ms: the profiler saw no device time")
    return wall_ms / n, dev_ms / n, len(ops) / n


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
    for mod in ("fused_ln", "fused_mlp", "fused_attention", "int8_dense"):
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
    prof_wall_ms, dev_ms, by_name = profile_window(lambda: step(state, frozen, batch), TRAIN_ACC)

    def share(*names):
        return sum(ms for key, ms in by_name.items() if any(n in key for n in names)) / dev_ms

    attention_share = {"frozen towers' attention (row 1)": share("tc_attention_fwd<false>"),
                       "flash forward (row 11)": share("tc_attention_fwd<true>"),
                       "flash backward (row 12)": share("tc_bwd_dq", "tc_bwd_dkdv"),
                       "of which dQ": share("tc_bwd_dq("), "of which dK/dV": share("tc_bwd_dkdv")}
    print("training attention share of device time:",
          ", ".join(f"{k} {v:.1%}" for k, v in attention_share.items()), f"[{card}]")
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
                   attention_share=attention_share, top_device_ms=dict(top))
    print(f"training (b): {TRAIN_MICRO} micro steps of B {TRAIN_B} (query {TRAIN_QLEN}, "
          f"passages {TRAIN_PLEN}, 4 int8 frozen towers), losses "
          + ", ".join(f"{x:.4f}" for x in losses) + f" at lr {TRAIN_LR}; eval loss (no "
          f"dropout) {eval_before:.4f} -> {eval_after:.4f}; frozen tower unchanged")
    print("training e2e:", json.dumps(metrics), f"[{card}]")
    del step, state, frozen
    torch.cuda.empty_cache()
    return counts, metrics


# ---------------------------------------------------------------------------
# phase 11: f32 training at the repo's own TOML geometry
# ---------------------------------------------------------------------------

def phase_train_f32(seed: int, dev, card: str):
    """Phase 11: make_train_step at configs/topiocqa_train.toml's geometry
    in f32 (the TOML through the port's load_config; it sets no dtype), cut
    to accumulation TRAIN_ACC and TRAIN_LR; returns (launch counts,
    metrics)."""
    from haconvdr_torch.config import load_config
    from haconvdr_torch.train.trainer import frozen_config

    exp = load_config(str(HERE / TRAIN_TOML))
    cfg, data = exp.model, exp.data
    tcfg = dataclasses.replace(exp.train, accumulation_steps=TRAIN_ACC, learning_rate=TRAIN_LR)
    check(cfg.dtype == "float32" and frozen_config(cfg, tcfg).dtype == "float32"
          and cfg.remat == "mlp" and cfg.attention_probs_dropout_prob == 0.1,
          f"train-f32: {TRAIN_TOML} no longer gives f32 towers with remat mlp, dropout 0.1")
    check((tcfg.per_device_train_batch_size, data.max_concat_length, data.max_doc_length)
          == (TRAIN_B, TRAIN_QLEN, TRAIN_PLEN)
          and tcfg.is_prepos_neg and not tcfg.is_pseudo_prepos,
          f"train-f32: {TRAIN_TOML}'s geometry is not B {TRAIN_B}, query {TRAIN_QLEN}, "
          f"passages {TRAIN_PLEN} with prepos negatives only")
    L, n_frozen = cfg.num_hidden_layers, 3  # pos, neg, prepos_neg
    step, state, frozen = train_setup(seed + 70, dev, cfg, tcfg)

    def checksum():
        return sum(float(t.double().sum()) for t in frozen.state_dict().values())

    before = checksum()
    batch = train_batch(seed + 80, TRAIN_B, cfg.vocab_size)
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
    print("train-f32 launch counts:", json.dumps(counts), f"({TRAIN_MICRO} micro steps)")
    check_train_counts(counts, L, n_frozen, TRAIN_MICRO, int8=False, what="train-f32")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"train-f32: non-finite loss {losses}")
    check(state.global_step == TRAIN_MICRO // TRAIN_ACC, "train-f32: wrong update count")
    check(checksum() == before, "train-f32: the frozen tower changed")
    prof_wall_ms, dev_ms, by_name = profile_window(lambda: step(state, frozen, batch), TRAIN_ACC)

    def share(*names):
        return sum(ms for key, ms in by_name.items() if any(n in key for n in names)) / dev_ms

    attention_share = {"frozen towers' attention (row 1)": share("tf32_attention_fwd<false>"),
                       "flash forward (row 11)": share("tf32_attention_fwd<true>"),
                       "flash backward (row 12)": share("tf32_bwd_dq", "tf32_bwd_dkdv"),
                       "of which dQ": share("tf32_bwd_dq("),
                       "of which dK/dV": share("tf32_bwd_dkdv")}
    print("train-f32 attention share of device time:",
          ", ".join(f"{k} {v:.1%}" for k, v in attention_share.items()), f"[{card}]")
    timed = secs[TRAIN_WARM:]
    med = float(np.median(timed))
    metrics = dict(examples_per_s=TRAIN_B * len(timed) / sum(timed),
                   examples_per_s_median_step=TRAIN_B / med, micro_step_ms_median=med * 1e3,
                   micro_step_ms=[x * 1e3 for x in secs], losses=losses, lr=TRAIN_LR,
                   peak_memory_gib=peak_gib, profiled_wall_ms=prof_wall_ms,
                   device_ms=dev_ms, idle_share=1.0 - dev_ms / prof_wall_ms,
                   attention_share=attention_share,
                   top_device_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:14]))
    print(f"train-f32: {TRAIN_MICRO} micro steps ({TRAIN_WARM} warm-up) of B {TRAIN_B} "
          f"(query {TRAIN_QLEN}, passages {TRAIN_PLEN}, f32 trained tower with remat "
          f"{cfg.remat!r} and dropout 0.1, {n_frozen} f32 frozen forwards) from {TRAIN_TOML}, "
          f"cut to accumulation {TRAIN_ACC} (not 8) and lr {TRAIN_LR} (not 1e-5); losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; frozen tower unchanged")
    print("train-f32 e2e:", json.dumps(metrics), f"[{card}]")
    del step, state, frozen
    torch.cuda.empty_cache()
    return counts, metrics


# ---------------------------------------------------------------------------
# phase 10: offline evaluation
# ---------------------------------------------------------------------------

class TimedStore:
    """An EmbeddingBlockStore that times each block: the host read up to
    the yield, then (synchronized) everything the searcher does with the
    block before it asks for the next one: the copy to the card, the
    search and the merge."""

    def __init__(self, store):
        self.store = store
        self.read_s, self.block_s = [], []

    def global_scale(self):
        return self.store.global_scale()

    def iter_blocks(self, num_blocks=-1, with_scales=False):
        t = time.perf_counter()
        for blk in self.store.iter_blocks(num_blocks, with_scales):
            now = time.perf_counter()
            self.read_s.append(now - t)
            yield blk
            torch.cuda.synchronize()
            t = time.perf_counter()
            self.block_s.append(t - now)


def words(rng, lo: int, hi: int) -> str:
    """lo to hi (inclusive) words of WORDS."""
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi + 1))))


def eval_records(seed: int):
    """TopiOCQA-format test records: EVAL_CONVS conversations of EVAL_TURNS
    turns, each turn a 4-14 word question with a gold passage of 150-250
    words; rel_label covers the prior turns."""
    rng = np.random.default_rng(seed)
    return [{"sample_id": f"TopiOCQA-test_{c + 1}_{t + 1}", "cur_utt_text": words(rng, 4, 14),
             "last_response": words(rng, 5, 30) if t else "",
             "pos_docs": [words(rng, 150, 250)], "pos_docs_pids": [0],
             "rel_label": [int(x) for x in rng.integers(0, 2, t)]}
            for c in range(EVAL_CONVS) for t in range(EVAL_TURNS)]


def prj_records(seed: int):
    """PRJ probes of PRJ_CONVS conversations at turn 3: '-0' the bare
    question, '-1' and '-2' paired with a history question."""
    rng = np.random.default_rng(seed)
    probes = []
    for c in range(PRJ_CONVS):
        q = words(rng, 4, 14)
        for k in range(3):
            probes.append({"id": f"{c + 1}-3-{k}", "conv_id": str(c + 1), "turn_id": "3",
                           "query": q, "query_pair": words(rng, 4, 14) if k else "",
                           "last_response": "", "pos_docs_id": []})
    return probes


def store_dir(need: int):
    """(directory, second block's rows): the first of the temporary
    directory and the checkout's build/ with room for the store; if neither
    has room, the second block shrinks to fit the roomiest (the first
    block, the reference's faiss block, never does)."""
    import shutil
    import tempfile

    margin = 2 << 30
    row_bytes = DIM * 4 + 8
    cands = [pathlib.Path(tempfile.gettempdir()), HERE / "build"]
    cands[1].mkdir(exist_ok=True)
    free = [(shutil.disk_usage(c).free, c) for c in cands]
    for f, c in free:
        if f >= need + margin:
            return c, EVAL_BLOCKS[1]
    f, c = max(free)
    second = (f - margin) // row_bytes - EVAL_BLOCKS[0]
    check(second > 0, f"no room for the eval store: {[(str(c), f) for f, c in free]}")
    return c, int(second)


def phase_offline_eval(seed: int, dev, params, cfg, card: str):
    """Phase 10: retrieval.py end to end at full width over an on-disk store
    of two float32 blocks (v4 on the first, seeded v3 on the second), then
    PRJ labeling over the same store."""
    import tempfile

    from haconvdr_torch import retrieval
    from haconvdr_torch.config import DataConfig, ExperimentConfig, SearchConfig
    from haconvdr_torch.data.prj import build_prj_probe_examples
    from haconvdr_torch.eval.trec import dedup_ranked_candidates
    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.models.encoder import AnceEncoder
    from haconvdr_torch.ops import topk_v4
    from haconvdr_torch.ops.fused_topk import (
        _finish,
        fused_topk_block_plain,
        order_keys,
        top_keys,
    )
    from haconvdr_torch.utils.io import pstore
    from haconvdr_torch.utils.testing import HashTokenizer

    stages = {}
    root, second = store_dir(sum(EVAL_BLOCKS) * (DIM * 4 + 8))
    blocks = (EVAL_BLOCKS[0], second)
    n_rows = sum(blocks)
    print(f"offline eval: store of {blocks[0]} + {blocks[1]} float32 rows "
          f"({n_rows * DIM * 4 / 1e9:.2f} GB) under {root}"
          + ("" if second == EVAL_BLOCKS[1] else f" (second block cut from {EVAL_BLOCKS[1]})"))
    tok = HashTokenizer(cfg.vocab_size)
    encoder = AnceEncoder.from_jax_params(params, cfg, dev)
    rng = np.random.default_rng(seed + 70)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        test_file = f"{tmp}/test.json"
        with open(test_file, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in eval_records(seed + 71))
        ecfg = ExperimentConfig(
            data=DataConfig(dataset="topiocqa", test_file_path=test_file, is_train=False,
                            use_PRL=False),  # the published convqp input, up to 512 tokens
            model=cfg,
            search=SearchConfig(passage_embeddings_dir_path=f"{tmp}/emb",
                                passage_offset2pid_path=f"{tmp}/offset2pid.pickle",
                                top_k=TOP_K, per_device_test_batch_size=64,
                                qrel_output_path=f"{tmp}/out",
                                trec_gold_qrel_file_path=f"{tmp}/qrel.trec"),
        )
        run_file = f"{ecfg.search.qrel_output_path}/{ecfg.search.output_trec_file}"
        # ---- the test queries: examples, then the tower
        t = time.perf_counter()
        examples = retrieval.build_test_examples(ecfg, tok)
        stages["build_examples_s"] = time.perf_counter() - t
        lens = [sum(e["conv_qp_mask"]) for e in examples]
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        embs, qids = retrieval.get_test_query_embeddings(ecfg, encoder, examples=examples)
        stages["encode_s"] = time.perf_counter() - t
        stages["encode_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        counts = read_counts()
        n_q = len(qids)
        check(embs.shape == (EVAL_CONVS * EVAL_TURNS, cfg.embedding_dim)
              and np.isfinite(embs).all(), "offline eval: query embeddings misshapen")
        # ---- the PRJ probes' embeddings, for their plants (the labeling
        # below encodes them again itself)
        probes = prj_records(seed + 72)
        with open(f"{tmp}/probes.json", "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in probes)
        p_emb, p_ids = retrieval.get_test_query_embeddings(
            ecfg, encoder, examples=build_prj_probe_examples(ecfg.data, tok, f"{tmp}/probes.json"),
            query_key="pair_query")
        non_base = [j for j, pid in enumerate(p_ids) if not pid.endswith("-0")]
        planted = sorted(rng.choice(non_base, PRJ_PLANTED, replace=False).tolist())
        # ---- the store: N(0, 1) rows made on the card, every test query's
        # and every planted probe's embedding at a seeded offset, one per v4
        # window (sw rows), so that no window holds two.  Plants are scaled
        # to one norm, sqrt(D): LayerNorm leaves the towers' norms a hair
        # apart, and a neighbour of marginally larger norm must not outscore
        # a query's own row
        plants = np.concatenate([embs, p_emb[planted]])
        plants = (plants / np.linalg.norm(plants, axis=1, keepdims=True)
                  * np.sqrt(DIM)).astype(np.float32)
        sw, _ = topk_v4.resolve_select_geometry(blocks[0], torch.float32)
        offsets = rng.choice(n_rows // sw, len(plants), replace=False) * sw
        offsets += rng.integers(0, sw, len(plants))
        offset2pid = rng.permutation(n_rows)
        pstore([int(x) for x in offset2pid], ecfg.search.passage_offset2pid_path)
        with open(ecfg.search.trec_gold_qrel_file_path, "w") as f:
            f.writelines(f"{q} 0 {offset2pid[o]} 1\n" for q, o in zip(qids, offsets))
        # probe qrels: a planted probe's gold is its row; every other
        # probe's gold is a pid no row holds (its MRR is 0)
        gold = {p_ids[j]: int(offset2pid[o]) for j, o in zip(planted, offsets[n_q:])}
        with open(f"{tmp}/probe_qrel.trec", "w") as f:
            f.writelines(f"{pid} Q0 {gold.get(pid, n_rows + j)} 1\n"
                         for j, pid in enumerate(p_ids))
        # each block is written, then scanned by the plain twins while it is
        # on the card: their exact top-k keys (offsets as ids) and each
        # query's best score over rows that hold no plant
        g = torch.Generator(device=dev).manual_seed(seed + 73)
        store = EmbeddingBlockStore(f"{tmp}/emb")
        q = torch.from_numpy(embs).to(dev)
        keys, best_random, base = [], torch.full((n_q,), float("-inf"), device=dev), 0
        t = time.perf_counter()
        for b, rows in enumerate(blocks):
            emb = torch.randn(rows, DIM, device=dev, generator=g)
            sel = (offsets >= base) & (offsets < base + rows)
            here = torch.from_numpy(offsets[sel] - base).to(dev)
            emb[here] = torch.from_numpy(plants[sel]).to(dev)
            store.write_block(b, emb.cpu().numpy(), np.arange(base, base + rows, dtype=np.int64))
            s, i = fused_topk_block_plain(q, emb, rows, TOP_K)
            keys.append(order_keys(s, torch.where(i >= 0, i.long() + base, -1)))
            emb[here] = 0.0  # planted rows score 0: out of the random maximum
            for c0 in range(0, rows, 1 << 18):
                best_random = torch.maximum(best_random, (q @ emb[c0:c0 + (1 << 18)].T).amax(1))
            del emb
            base += rows
        torch.cuda.synchronize()
        stages["store_write_and_reference_s"] = time.perf_counter() - t
        rs, ri = _finish(top_keys(torch.cat(keys, 1), TOP_K))
        self_s = (q * torch.from_numpy(plants[:n_q]).to(dev)).sum(1)
        margin = float((self_s - best_random).min())
        nearest = float((rs[:, 0] - rs[:, 1]).min())
        del q, keys
        torch.cuda.empty_cache()
        # ---- search + dedup + TREC run + metrics, counted after the encode
        timed = TimedStore(store)
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = retrieval.gen_metric_score_and_save(ecfg, embs, qids, store=timed, device=dev)
        stages["search_write_eval_s"] = time.perf_counter() - t
        stages["search_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for mod, c in read_counts().items():
            for key, n in c.items():
                counts[mod][key] += n
        stages["block_read_s"], stages["block_search_s"] = timed.read_s, timed.block_s
        stages["dedup_write_eval_s"] = (stages["search_write_eval_s"] - sum(timed.read_s)
                                        - sum(timed.block_s))
        print("offline eval launch counts:", json.dumps(counts))
        n_batches = -(-n_q // 64)
        check(counts["fused_attention"]["kernel"] == cfg.num_hidden_layers * n_batches,
              f"offline eval: attention launched {counts['fused_attention']['kernel']} times, "
              f"not {cfg.num_hidden_layers} x {n_batches}")
        check_counts(counts, [("fused_attention", "kernel"), ("topk_v4", "window"),
                              ("topk_v4", "select_t"), ("topk_v4", "select"),
                              ("topk_v4", "rescore"), ("fused_topk", "kernel")], "offline eval")
        print(f"offline eval: v3_fallback {counts['topk_v4']['v3_fallback']}")
        print("offline eval metrics:", json.dumps(res))
        for key in ("MRR", "NDCG@3", "Recall@10", "Recall@100"):
            check(res.get(key) == 100.0, f"offline eval: {key} {res.get(key)}, not 100.0")
        check(margin > 0, f"offline eval: a random row outscores a planted query ({margin})")
        # ---- the run against the plain twins' top-k, mapped and deduped
        # the same way: every column in the reference's layout
        ref = dedup_ranked_candidates(qids, rs.cpu().numpy(), ri.cpu().numpy(), offset2pid, TOP_K)
        with open(run_file) as f:
            lines = [line.split() for line in f]
        check(len(lines) == n_q * TOP_K and all(
            x[:2] == [qids[j // TOP_K], "Q0"] and x[3:5] == [str(j % TOP_K + 1),
                                                             str(199 - j % TOP_K)]
            and x[6] == "ance" for j, x in enumerate(lines)),
            "offline eval: TREC run out of the reference's layout")
        got_s = torch.tensor([float(x[5]) for x in lines]).view(n_q, TOP_K)
        got_i = torch.tensor([int(x[2]) for x in lines]).view(n_q, TOP_K)
        ref_s = torch.tensor([[x[1] for x in ref[qid]] for qid in qids])
        ref_i = torch.tensor([[x[0] for x in ref[qid]] for qid in qids])
        err = compare_topk(got_s, got_i, ref_s, ref_i, "offline eval TREC run")
        stages["max_abs_err"] = err
        print(f"offline eval: {n_q} queries (conv_qp {min(lens)}-{max(lens)} tokens); the TREC "
              f"run equals the plain twins' (max |diff| {err:.3g}); self-score minus the best "
              f"random row >= {margin:.2f}, minus the next row >= {nearest:.4g}")
        # ---- PRJ labeling with its own encode over the same store
        timed = TimedStore(store)
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rel = retrieval.run_prj_labeling(ecfg, encoder, probes, f"{tmp}/probe_qrel.trec", tok,
                                         store=timed)
        stages["prj_s"] = time.perf_counter() - t
        stages["prj_block_read_s"], stages["prj_block_search_s"] = timed.read_s, timed.block_s
        prj_counts = read_counts()
        print("PRJ launch counts:", json.dumps(prj_counts))
        check(prj_counts["fused_attention"]["kernel"]
              == cfg.num_hidden_layers * -(-len(probes) // 64), "PRJ: attention launches")
        check_counts(prj_counts, [("fused_attention", "kernel"), ("topk_v4", "window"),
                                  ("fused_topk", "kernel")], "PRJ")
        want = {}
        for c in range(PRJ_CONVS):
            want[f"{c + 1}-1"] = []
            want[f"{c + 1}-3"] = [int(f"{c + 1}-3-{k}" in gold) for k in (1, 2)]
        check(rel == want, f"PRJ: labels differ from the plants: {rel} vs {want}")
        print(f"PRJ: {len(probes)} probes, {len(gold)} planted: the labels equal the plants "
              f"({sum(map(sum, rel.values()))} ones)")
    stages["eval_queries_per_s"] = n_q / (stages["encode_s"] + stages["search_write_eval_s"])
    stages["v3_fallback"] = counts["topk_v4"]["v3_fallback"]
    stages["metrics"] = res
    print("offline eval e2e:", json.dumps(stages), f"[{card}]")
    del encoder
    torch.cuda.empty_cache()
    return counts, stages


# ---------------------------------------------------------------------------
# phase 12: load and serve over HTTP
# ---------------------------------------------------------------------------

HTTP_CLIENTS = 128  # the burst: phase 4's batched requests, one client thread each
HTTP_BATCH = 64  # one POST /retrieve_batch


def http_call(srv, path: str, body=None, timeout: float = 600.0):
    """(status, JSON reply) of a GET (body None) or a JSON POST."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}", data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def http_body(req) -> dict:
    question, history, passages = req
    return {"question": question, "history": [list(t) for t in history],
            "history_passages": passages}


def room_for(need: int) -> pathlib.Path:
    """The first of the temporary directory and the checkout's build/ with
    ``need`` bytes free beyond a 2 GiB margin."""
    import shutil
    import tempfile

    cands = [pathlib.Path(tempfile.gettempdir()), HERE / "build"]
    cands[1].mkdir(exist_ok=True)
    free = [(shutil.disk_usage(c).free, c) for c in cands]
    for f, c in free:
        if f >= need + (2 << 30):
            return c
    raise RuntimeError(f"no room for {need} bytes: {[(str(c), f) for f, c in free]}")


def phase_http(seed: int, dev, params, cfg, served, p_sum: float, card: str):
    """Phase 12: the phase-4 index and tower written to disk (an
    EmbeddingBlockStore of one block, an offset2pid pickle, an HF
    checkpoint), loaded back by Retriever.load, and served by
    RetrievalServer to 128 concurrent HTTP clients, then one
    /retrieve_batch of 64; answers held to sequential Retriever.retrieve."""
    import tempfile
    import urllib.error

    from haconvdr_torch.config import DataConfig, SearchConfig
    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.models.hf_import import load_tokenizer, save_hf_checkpoint
    from haconvdr_torch.serve import Retriever
    from haconvdr_torch.serve_http import RetrievalServer
    from haconvdr_torch.utils.io import pload, pstore
    from haconvdr_torch.utils.testing import hash_tokenizer_transformers, write_tokenizer_files

    stages = {}
    root = room_for(N_ROWS * (DIM * 4 + 8) + (1 << 30))
    g = torch.Generator(device=dev).manual_seed(seed)
    passages = torch.randn(N_ROWS, DIM, device=dev, generator=g)  # phase 4's rows
    check(float(passages.sum(dtype=torch.float64)) == p_sum,
          "load and serve: the regenerated rows differ from phase 4's")
    import importlib.util

    real = importlib.util.find_spec("transformers") is not None
    if real:
        from importlib.metadata import version

        print(f"load and serve: transformers {version('transformers')} installed; "
              f"Retriever.load reads a RobertaTokenizer from offline byte-level vocab.json / "
              f"merges.txt in the checkpoint")
    else:
        sys.modules["transformers"] = hash_tokenizer_transformers(cfg.vocab_size)
        print(f"load and serve: transformers not installed; a stand-in module hands out "
              f"HashTokenizer({cfg.vocab_size}), as phase 4's retriever used")
    try:
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            t = time.perf_counter()
            EmbeddingBlockStore(f"{tmp}/emb").write_block(
                0, passages.cpu().numpy(), np.arange(N_ROWS, dtype=np.int64))
            offset2pid = np.arange(N_ROWS, dtype=np.int64) * 7 + 11  # as phase 4
            pstore(offset2pid, f"{tmp}/offset2pid.pickle")
            save_hf_checkpoint(params, cfg, f"{tmp}/ckpt")
            if real:
                write_tokenizer_files(f"{tmp}/ckpt")
            stages["write_s"] = time.perf_counter() - t
            print(f"load and serve: store of {N_ROWS}x{DIM} float32 "
                  f"({N_ROWS * DIM * 4 / 1e9:.2f} GB), offset2pid and checkpoint written "
                  f"under {root} in {stages['write_s']:.1f} s")
            if real:  # transformers' first use (its lazy imports), timed apart
                t = time.perf_counter()
                load_tokenizer("ANCE", f"{tmp}/ckpt")
                stages["tokenizer_first_s"] = time.perf_counter() - t
                print(f"load and serve: the first tokenizer load took "
                      f"{stages['tokenizer_first_s']:.2f} s (a cold start's share, not in "
                      f"Retriever.load's seconds below)")
            torch.cuda.synchronize()
            t = time.perf_counter()
            retriever = Retriever.load(
                f"{tmp}/ckpt", f"{tmp}/emb", offset2pid=pload(f"{tmp}/offset2pid.pickle"),
                data_cfg=DataConfig(is_train=False, use_PRL=False),  # max_concat_length 512
                search_cfg=SearchConfig(top_k=TOP_K, per_device_test_batch_size=64),
                resident=True, store_dtype="float32", device=dev,
            )
            torch.cuda.synchronize()
            stages["load_s"] = time.perf_counter() - t
        sd = retriever.encoder.state_dict()
        check(sd.keys() == served.keys() and all(torch.equal(sd[k].cpu(), served[k]) for k in sd),
              "load and serve: the loaded tower differs from the one phase 4 served")
        check(torch.equal(retriever.index.passages, passages),
              "load and serve: the loaded index differs from phase 4's rows")
        del passages, sd
        torch.cuda.empty_cache()
        print(f"load and serve: Retriever.load {stages['load_s']:.2f} s (checkpoint read, "
              f"store read and copy to the card); the tower equals phase 4's bit for bit, the "
              f"index its rows [{card}]")

        reqs = make_requests(seed, N_BATCHED + N_SINGLE)  # phase 4's requests
        burst, lone = reqs[:HTTP_CLIENTS], reqs[HTTP_CLIENTS]
        search_qs = []
        search = retriever.index.search

        def recording_search(queries, k):
            search_qs.append(int(np.asarray(queries).shape[0]))
            return search(queries, k)

        retriever.index.search = recording_search
        log = DispatchLog(retriever)
        srv = RetrievalServer(retriever, port=0, max_batch=64, max_wait_ms=2.0).start()
        answers = [None] * HTTP_CLIENTS
        latency = [0.0] * HTTP_CLIENTS
        gate = threading.Barrier(HTTP_CLIENTS + 1)

        failed = {}

        def client(j):
            gate.wait()
            t0 = time.perf_counter()
            try:
                answers[j] = http_call(srv, "/retrieve", http_body(burst[j]))[1]["hits"]
            except urllib.error.HTTPError as e:
                failed[j] = f"{e.code} {e.read()[:200]!r}"
            latency[j] = time.perf_counter() - t0

        zero_counts()
        try:
            # one lone request first (a dispatch of one: route a), then the burst
            lone_hits = http_call(srv, "/retrieve", http_body(lone))[1]["hits"]
            threads = [threading.Thread(target=client, args=(j,)) for j in range(HTTP_CLIENTS)]
            for th in threads:
                th.start()
            gate.wait()
            t = time.perf_counter()
            for th in threads:
                th.join(timeout=900)
            stages["burst_wall_s"] = time.perf_counter() - t
            check(all(not th.is_alive() and a is not None for th, a in zip(threads, answers)),
                  f"load and serve: burst clients did not all finish ({len(failed)} refused, "
                  f"first {list(failed.items())[:2]})")
            _, batch = http_call(srv, "/retrieve_batch",
                                 {"queries": [http_body(r) for r in burst[:HTTP_BATCH]]})
            code, health = http_call(srv, "/healthz")
            check(code == 200 and health["ok"] is True, f"load and serve: /healthz {health}")
            _, stats = http_call(srv, "/stats")
        finally:
            srv.close()
            log.close()
        counts = read_counts()
        refused = False
        try:
            http_call(srv, "/retrieve", http_body(lone), timeout=10)
        except (urllib.error.URLError, ConnectionError, OSError):
            refused = True
        check(refused, "load and serve: a request after close() was answered")
        print("load and serve launch counts:", json.dumps(counts))
        check_counts(counts, [("fused_attention", "kernel"), ("topk_v4", "window"),
                              ("topk_v4", "select_t"), ("topk_v4", "select")], "load and serve")
        check_window_routes(counts, search_qs, torch.float32, "load and serve", card)
        n_served = 1 + HTTP_CLIENTS + HTTP_BATCH
        hist = {int(n): c for n, c in stats["batch_histogram"].items()}
        check(stats["served"] == n_served and stats["queries"] == n_served
              and stats["errors"] == 0,
              f"load and serve: /stats served {stats['served']}, queries {stats['queries']}, "
              f"errors {stats['errors']}; {n_served} were sent")
        check(sum(n * c for n, c in hist.items()) == n_served and max(hist) > 1,
              f"load and serve: dispatch histogram {hist}")
        check(stats["dispatches"] == len(search_qs), "load and serve: dispatches vs searches")

        # ---- every answer against the retriever's own answer for the same
        # request.  A dispatch embeds its n requests in one batch of n rows,
        # packed to their rows' lengths, so a row's
        # embedding depends on the token rows of its batch (the GEMMs' row
        # count).  So each answer must equal, bit for bit, its dispatch run
        # again (``DispatchLog``); and it is held to a sequential
        # Retriever.retrieve (batch 1) as kernel answers are held to plain
        # ones, with the id rule's separation widened by the most the
        # batch-1 embedding can move a score, delta = ||q_batch - q_1|| x the
        # largest row norm of the index.  The drift itself is held to 1e-5
        # ||q_1|| (float32 tiling noise), and at least half the ranks must
        # stay separated, so a batched tower that drifts fails rather than
        # widening its own tolerance.
        got = [lone_hits] + answers + [r["hits"] for r in batch["results"]]
        asked = [HTTP_CLIENTS] + list(range(HTTP_CLIENTS)) + list(range(HTTP_BATCH))  # in reqs
        examples = [retriever.build_query(*r) for r in reqs[:HTTP_CLIENTS + 1]]
        rerun = log.rerun()
        stages["padded_score_err"] = log.against_padded("load and serve")
        max_norm = float(retriever.index.passages.norm(dim=1).max())
        seq, deltas, drifts, seps = {}, [], [], []
        for j, r in enumerate(asked):
            hits = [(h["pid"], h["score"]) for h in got[j]]
            match = [q for q, ans in rerun[DispatchLog.key(examples[r]["conv_qp"])]
                     if ans == hits]
            check(len(hits) == TOP_K and bool(match),
                  f"load and serve: request {j}: {len(hits)} hits, equal to no run of its "
                  "dispatch")
            if r not in seq:  # k + 1: the gap past the last rank is known
                seq[r] = (retriever.retrieve(*reqs[r], k=TOP_K + 1),
                          retriever.embed([examples[r]])[0])
            ref, q1 = seq[r]
            check(len(ref) == TOP_K + 1, f"load and serve: sequential request {j}: "
                  f"{len(ref)} hits")
            drift = float(np.linalg.norm(match[0] - q1))
            rel = drift / float(np.linalg.norm(q1))
            check(rel <= 1e-5, f"load and serve: request {j}: the batched embedding "
                  f"is {rel:.3g} of its norm from the batch-1 one (limit 1e-5)")
            delta = drift * max_norm
            deltas.append(delta)
            drifts.append(rel)
            s, rs = np.array([x for _, x in hits]), np.array([x for _, x in ref])
            check(bool((np.abs(s - rs[:TOP_K]) <= 1e-4 * np.abs(rs[:TOP_K]) + delta).all()),
                  f"load and serve: request {j}: scores beyond 1e-4 rel + {delta:.3g}")
            gap = np.abs(np.diff(rs)) > 1e-5 * np.abs(rs[1:]) + 2 * delta  # TOP_K gaps
            sep = np.concatenate([[True], gap[:-1]]) & gap
            seps.append(int(sep.sum()))
            check(sep.sum() >= TOP_K // 2, f"load and serve: request {j}: only {sep.sum()} of "
                  f"{TOP_K} ranks separated (delta {delta:.3g})")
            check(np.array_equal(np.array([p for p, _ in hits])[sep],
                                 np.array([p for p, _ in ref[:TOP_K]])[sep]),
                  f"load and serve: request {j}: ids differ from the sequential answer at "
                  f"separated scores (delta {delta:.3g})")
        stages.update(seq_delta_max=max(deltas), seq_drift_max=max(drifts),
                      separated_min=min(seps))
        print(f"load and serve: every answer equals its dispatch run again ({len(log.runs)} "
              f"tower calls), bit for bit; against sequential "
              f"Retriever.retrieve within delta <= {max(deltas):.3g} (embedding drift <= "
              f"{max(drifts):.3g} of its norm), ids equal at >= {min(seps)} of {TOP_K} ranks")
        stages.update(
            requests_per_s=HTTP_CLIENTS / stages["burst_wall_s"],
            client_p50_ms=float(np.median(latency)) * 1e3, client_max_ms=max(latency) * 1e3,
            server_latency_ms=stats["latency_ms"], dispatches=stats["dispatches"],
            batch_histogram=dict(sorted(hist.items())),
        )
        print(f"load and serve: {n_served} answers over HTTP ({HTTP_CLIENTS} concurrent, one "
              f"/retrieve_batch of {HTTP_BATCH}, one alone); /stats served {stats['served']}, "
              f"errors 0")
        print("load and serve e2e:", json.dumps(stages), f"[{card}]")
    finally:
        if not real:
            sys.modules.pop("transformers", None)
    del retriever
    torch.cuda.empty_cache()
    return counts, stages


# ---------------------------------------------------------------------------
# phase 13: the IVF serving tier
# ---------------------------------------------------------------------------

# 64 unit-norm modes and a per-dimension noise of 0.06: a mode spans ~16 of
# the 1,024 clusters, so nprobe 8 misses part of a query's top 100 and
# nprobe 32 covers it (probes/probe_torch_ivf.py)
IVF_MODES, IVF_NOISE = 64, 0.06
IVF_NLIST, IVF_NPROBE = 1024, 32
IVF_PROBES = (8, 32, 64)  # recall@100 against the flat search
IVF_RECALL_FLOOR = 0.99  # recall@100 at IVF_NPROBE
IVF_QS = (1, 8, 64)  # search ms, IVF beside the flat v4 search
IVF_RECALL_Q, IVF_FULL_Q, IVF_CPU_Q = 256, 32, 8
IVF_BATCHED = 128  # concurrent clients, as phase 12 (max_batch 16)
# the caching allocator's counters read around the serving runs: a device
# malloc or free (and a retry, which frees cached blocks) synchronizes
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_sync_all_streams", "num_alloc_retries")
IVF_SINGLE = 300  # single requests through each retriever, in turn


def ivf_corpus(seed: int, dev, n_modes: int = IVF_MODES, noise: float = IVF_NOISE):
    """(rows [N_ROWS, DIM], queries [IVF_RECALL_Q, DIM]) float32 on the card:
    ``n_modes`` unit-norm modes plus N(0, noise^2) noise per dimension,
    from the seed.  Isotropic rows would not cluster."""
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    modes = F.normalize(torch.randn(n_modes, DIM, device=dev, generator=g), dim=1)

    def draw(n):
        pick = torch.randint(0, n_modes, (n,), device=dev, generator=g)
        return modes[pick] + noise * torch.randn(n, DIM, device=dev, generator=g)

    rows = torch.empty(N_ROWS, DIM, device=dev)
    for r0 in range(0, N_ROWS, 1 << 18):
        rows[r0 : r0 + (1 << 18)] = draw(min(1 << 18, N_ROWS - r0))
    return rows, draw(IVF_RECALL_Q)


def alloc_counts() -> dict:
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ALLOC_KEYS}


def alloc_delta(before: dict) -> dict:
    after = alloc_counts()
    return {k: after[k] - before[k] for k in ALLOC_KEYS}


def recall_at(ids, ref_ids) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                          for a, b in zip(ids, ref_ids)]))


def phase_ivf(seed: int, dev, params, cfg, card: str, tmp: str):
    """Phase 13: cli/build_ivf over a 2.5M x 768 Gaussian-mixture store,
    Retriever(ivf=True) reloading its directory with the f32 tower, an
    in-process residual-int8 build with the two-stage rescore, single
    requests and BatchingRetriever(max_batch=16) beside flat retrievers;
    answers held to the flat v4 search, the CPU and the build.  The store
    (``{tmp}/emb``) and the build (``{tmp}/ivf``) stay in ``tmp`` for phase 14."""

    from haconvdr_torch.cli import build_ivf as build_cli
    from haconvdr_torch.config import DataConfig, SearchConfig
    from haconvdr_torch.index import ivf
    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.parallel.sharded_ivf import load_ivf_sharded
    from haconvdr_torch.parallel.sharded_search import ShardedIndex
    from haconvdr_torch.serve import BatchingRetriever, Retriever
    from haconvdr_torch.utils.testing import HashTokenizer

    stages = {}
    rows, mq = ivf_corpus(seed, dev)
    flat16 = ShardedIndex.from_tensor(rows, dtype="bfloat16")  # the buckets' scoring model
    flat32 = ShardedIndex.from_tensor(rows)
    root = pathlib.Path(tmp).parent

    def retriever(store, store_dtype, ivf_dir=None, **kw):
        return Retriever(
            HashTokenizer(cfg.vocab_size), params, cfg, store,
            data_cfg=DataConfig(is_train=False, use_PRL=False),
            search_cfg=SearchConfig(top_k=TOP_K, per_device_test_batch_size=64, **kw),
            store_dtype=store_dtype, ivf=True, ivf_nlist=IVF_NLIST, ivf_nprobe=IVF_NPROBE,
            ivf_dir=ivf_dir, device=dev,
        )

    t = time.perf_counter()
    EmbeddingBlockStore(f"{tmp}/emb").write_block(
        0, rows.cpu().numpy(), np.arange(N_ROWS, dtype=np.int64))
    stages["store_write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    built, stats = build_cli.main([
        f"embeddings={tmp}/emb", f"out={tmp}/ivf", f"nlist={IVF_NLIST}",
        f"nprobe={IVF_NPROBE}", "dtype=bfloat16", f"seed={seed}", "--device", str(dev)])
    stages["build_cli_s"] = time.perf_counter() - t
    stages.update(build_s=stats["build_s"], save_s=stats["save_s"],
                  capacity=stats["capacity"], tail_rows=stats["tail_rows"],
                  bucket_bytes=(built.buckets.numel() + built.tail.numel()) * 2)
    check(stats["nlist"] == IVF_NLIST and stats["dtype"] == "bfloat16",
          f"ivf: build_ivf printed {stats}")
    t = time.perf_counter()
    load_ivf_sharded(f"{tmp}/ivf", device=dev)  # the index alone, then the retriever
    torch.cuda.synchronize()
    stages["load_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    r16 = retriever(EmbeddingBlockStore(f"{tmp}/emb"), "bfloat16", ivf_dir=f"{tmp}/ivf")
    torch.cuda.synchronize()
    stages["reload_s"] = time.perf_counter() - t
    check(r16.ivf_index is not None and r16.index is None, "ivf: no IVF index reloaded")
    t = time.perf_counter()
    r8 = retriever(EmbeddingBlockStore(f"{tmp}/emb"), "int8", rescore_oversample=3.0)
    torch.cuda.synchronize()
    stages["int8_build_s"] = time.perf_counter() - t
    idx, idx8 = r16.ivf_index, r8.ivf_index
    check(idx8.buckets.dtype == torch.int8 and idx8.means is not None,
          "ivf: the int8 build is not residual int8")
    for name in ivf.ARRAYS:
        check(torch.equal(getattr(idx, name), getattr(built, name)),
              f"ivf: the reloaded {name} differs from the build's")
    q64 = mq[:64]
    s_b, i_b = ivf.ivf_search(built, q64, k=TOP_K)
    s_r, i_r = r16.search(q64.cpu().numpy())
    check(np.array_equal(s_b, s_r) and np.array_equal(i_b, i_r),
          "ivf: the reloaded retriever's answers differ from the build's")
    del built
    # the two-stage int8 answers (the rescore reads the store on disk)
    s8, i8 = r8.search(mq.cpu().numpy())
    _, i8_all = ivf.ivf_search(idx8, mq[:IVF_FULL_Q], k=TOP_K, nprobe=IVF_NLIST)
    del r8
    torch.cuda.empty_cache()
    print(f"ivf: {N_ROWS}x{DIM} f32 store written in {stages['store_write_s']:.1f} s under "
          f"{root}; cli/build_ivf nlist {IVF_NLIST} bfloat16: build {stats['build_s']} s, save "
          f"{stats['save_s']} s ({stages['build_cli_s']:.1f} s in all), capacity "
          f"{stats['capacity']}, tail {stats['tail_rows']} rows, buckets "
          f"{stages['bucket_bytes'] / 1e9:.3f} GB; load_ivf_sharded {stages['load_s']:.2f} s, "
          f"Retriever(ivf=True) reload {stages['reload_s']:.2f} s (the tower with it), equal to "
          f"the build bit for bit; residual-int8 build "
          f"{stages['int8_build_s']:.1f} s [{card}]")

    # ---- full probe equals the flat search; the card equals the CPU
    fs, fi = flat16.search(mq[:IVF_FULL_Q], TOP_K)
    s, i = ivf.ivf_search(idx, mq[:IVF_FULL_Q], k=TOP_K, nprobe=IVF_NLIST)
    compare_topk(torch.from_numpy(s), torch.from_numpy(i), torch.from_numpy(fs),
                 torch.from_numpy(fi), "ivf: nprobe = nlist against the flat bf16 search")
    cpu = ivf.IVFIndex(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in idx])
    t = time.perf_counter()
    cs, ci = ivf.ivf_search(cpu, mq[:IVF_CPU_Q].cpu(), k=TOP_K)
    stages["cpu_search_s"] = time.perf_counter() - t
    del cpu
    s, i = ivf.ivf_search(idx, mq[:IVF_CPU_Q], k=TOP_K)
    compare_topk(torch.from_numpy(s), torch.from_numpy(i), torch.from_numpy(cs),
                 torch.from_numpy(ci), "ivf: the card against the CPU")
    print(f"ivf: nprobe {IVF_NLIST} equals the flat bf16 v4 search for {IVF_FULL_Q} queries; "
          f"nprobe {IVF_NPROBE} on the card equals the CPU's ivf_search for {IVF_CPU_Q} "
          f"({stages['cpu_search_s']:.1f} s on the host)")

    # ---- recall@100 against the flat searches
    _, gt16 = flat16.search(mq, TOP_K)
    _, gt32 = flat32.search(mq, TOP_K)
    recall = {p: recall_at(ivf.ivf_search(idx, mq, k=TOP_K, nprobe=p)[1], gt16)
              for p in IVF_PROBES}
    stages["recall_at_100"] = recall
    stages["int8_two_stage_recall_at_100"] = recall_at(i8, gt32)
    stages["int8_full_probe_recall_at_100"] = recall_at(i8_all, gt32[:IVF_FULL_Q])
    check(recall[8] <= recall[32] <= recall[64], f"ivf: recall falls with nprobe: {recall}")
    check(recall[IVF_NPROBE] >= IVF_RECALL_FLOOR,
          f"ivf: recall@100 {recall[IVF_NPROBE]} at nprobe {IVF_NPROBE} < {IVF_RECALL_FLOOR}")
    print(f"ivf: recall@100 against the flat bf16 search over {IVF_RECALL_Q} mixture queries "
          f"{json.dumps(recall)}; residual int8 nprobe {IVF_NPROBE} + rescore x3 against the "
          f"flat f32 search {stages['int8_two_stage_recall_at_100']:.4f} (one stage at nprobe "
          f"{IVF_NLIST}: {stages['int8_full_probe_recall_at_100']:.4f}) [{card}]")

    # ---- search ms, IVF beside the flat v4 search: CUDA events around 10
    # calls back to back (the host's time to enqueue them included), and
    # torch.profiler's device ms per call (device_ms cannot time it: a call
    # queues 136-1,058 device operations at Q 1-64, and the host blocks
    # once about a thousand wait behind device_ms's spin)
    ms = {}
    for Q in IVF_QS:
        q = mq[:Q]
        fns = {"ivf": lambda: ivf.ivf_search_device(idx, q, TOP_K, IVF_NPROBE),
               "flat_bf16": lambda: flat16.search_device(q, TOP_K),
               "flat_f32": lambda: flat32.search_device(q, TOP_K)}
        ms[Q] = {}
        for name, fn in fns.items():
            _, dev_ms, ops = profiled_ms(fn, 10)
            ms[Q][name] = {"events": cuda_ms(fn, 10), "device": dev_ms, "device_ops": ops}
    stages["search_ms"] = ms
    for Q, m in ms.items():
        print(f"ivf search Q {Q} at nprobe {IVF_NPROBE}, ms as events (the host's enqueue "
              "included) / profiler device (device operations a call): " + ", ".join(
                  f"{name} {v['events']:.3f} / {v['device']:.3f} ({v['device_ops']:.0f})"
                  for name, v in m.items()) + f" [{card}]")
    del flat16, flat32
    torch.cuda.empty_cache()

    # ---- the serving path: single requests in turn through the IVF
    # retriever and flat f32 and bf16 ones, then IVF_BATCHED concurrent
    # clients through BatchingRetriever(max_batch=16) over IVF and flat bf16
    served = {"ivf": r16,
              "flat_f32": build_retriever(params, cfg, dev, rows, None),
              "flat_bf16": build_retriever(params, cfg, dev, rows, None, store_dtype="bfloat16")}
    del rows
    torch.cuda.empty_cache()
    reqs = make_requests(seed + 13, IVF_BATCHED + IVF_SINGLE)
    search_qs = []
    search = r16.search

    def recording_search(queries, k=None):
        search_qs.append(int(np.asarray(queries).shape[0]))
        return search(queries, k)

    r16.search = recording_search
    for r in served.values():
        r.retrieve(*reqs[0])
    log = DispatchLog(r16)
    zero_counts()
    stages["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    before = alloc_counts()
    singles, lat = [], {name: [] for name in served}
    for req in reqs[IVF_BATCHED:]:
        for name, r in served.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            hits = r.retrieve(*req)
            lat[name].append((time.perf_counter() - t) * 1e3)
            if r is r16:
                singles.append(hits)
    stages["single_allocator"] = alloc_delta(before)
    batched = {}
    for name in ("ivf", "flat_bf16"):
        got = [None] * IVF_BATCHED
        before = alloc_counts()
        with BatchingRetriever(served[name], max_batch=16, max_wait_ms=50.0) as batcher:
            def client(j):
                got[j] = batcher.submit(*reqs[j]).result(timeout=600)

            threads = [threading.Thread(target=client, args=(j,)) for j in range(IVF_BATCHED)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            wall = time.perf_counter() - t
            st = batcher.stats()
        check(all(not th.is_alive() for th in threads), f"ivf: {name}'s batched clients hung")
        batched[name] = {"requests_per_s": IVF_BATCHED / wall, "dispatches": st["dispatches"],
                         "batch_histogram": st["batch_histogram"],
                         "allocator": alloc_delta(before)}
        if name == "ivf":
            answers = got
    counts = read_counts()
    log.close()
    r16.search = search
    check(all(a is not None and len(a) == TOP_K for a in answers + singles),
          "ivf: a request got no answer or fewer than k hits")
    print("ivf launch counts:", json.dumps(counts))
    check_counts(counts, [("fused_attention", "kernel"), ("topk_v4", "window"),
                          ("topk_v4", "select_t"), ("topk_v4", "select")], "ivf")
    # each IVF answer is its dispatch (or its single call) run again, bit for
    # bit (a row's embedding depends on the token rows of its batch)
    examples = [r16.build_query(*r) for r in reqs]
    rerun = log.rerun()
    stages["padded_score_err"] = log.against_padded("ivf")
    for j, ans in enumerate(answers + singles):  # singles follow the batched in reqs
        check(any(h == ans for _, h in rerun[DispatchLog.key(examples[j]["conv_qp"])]),
              f"ivf: request {j} equals no run of its dispatch")
    # tower queries: recall of nprobe 32 against the flat f32 search
    tq = r16.embed(examples)
    stages["tower_query_recall_at_100"] = recall_at(
        r16.search(tq)[1], served["flat_f32"].index.search(tq, TOP_K)[1])
    stages["single_ms"] = {name: {f"p{p}": float(np.percentile(v, p)) for p in (50, 90, 99)}
                           for name, v in lat.items()}
    # per request, IVF less each flat retriever (the same request, in turn)
    stages["single_paired_median_ms"] = {
        name: float(np.median(np.subtract(lat["ivf"], lat[name]))) for name in lat if name != "ivf"}
    stages["batched"] = batched
    print(f"ivf single requests, {IVF_SINGLE} each in turn (ms p50 / p90 / p99): " + ", ".join(
        f"{name} {v['p50']:.3f} / {v['p90']:.3f} / {v['p99']:.3f}"
        for name, v in stages["single_ms"].items()) + "; the median of IVF less flat per request: "
        + ", ".join(f"{name} {d:+.3f}" for name, d in stages["single_paired_median_ms"].items())
        + f" [{card}]")
    print(f"ivf BatchingRetriever(max_batch=16), {IVF_BATCHED} concurrent clients: " + ", ".join(
        f"{name} {v['requests_per_s']:.1f} requests/s in {v['dispatches']} dispatches "
        f"{json.dumps(v['batch_histogram'])}, allocator {json.dumps(v['allocator'])}"
        for name, v in batched.items())
        + f"; tower-query recall@100 {stages['tower_query_recall_at_100']:.4f} [{card}]")
    print("ivf e2e:", json.dumps(stages), f"[{card}]")
    del r16, served, idx
    torch.cuda.empty_cache()
    return counts, stages


# ---------------------------------------------------------------------------
# phase 14: the multi-device layer, as shard slots on the one card
# ---------------------------------------------------------------------------

MESH_SLOTS = 4  # shard slots on the one card
MESH_QS = (1, 64, 256)
MESH_TIMED_QS = (1, 256)  # sharded beside one-shard search ms (context)
MESH_CASES = ((TOP_K, "v4"), (TOP_K, "v3"), (300, "v4"))  # k 300: the plain path (k > 128)
MESH_BATCHED = 64  # concurrent requests through BatchingRetriever(max_batch=64)
MP_WORLD, MP_TIMEOUT_S = 2, 300  # the two-process phase: ranks, seconds a child may take


def add_counts(total, counts):
    for mod, c in counts.items():
        for key, n in c.items():
            total.setdefault(mod, {}).setdefault(key, 0)
            total[mod][key] += n


def merged_int8_plain(index, q, k: int, kernel: str):
    """Each non-empty shard scored plainly with its own scale, merged in
    shard order: int8 x int8 (per-query codes of the folded queries) where
    the v4 search runs (k <= 128), else the bfloat16-rounded folded queries
    (the v3 kernel's and the plain path's model)."""
    from haconvdr_torch.index.quantize import quantize_queries_int8
    from haconvdr_torch.ops.fused_topk import MAX_K, fused_topk_block_plain
    from haconvdr_torch.ops.topk import merge_lists

    parts = []
    for sh in index.shards:
        n = sh.passages.shape[0]
        if not n:
            continue
        qf = q.to(torch.float32) * sh.scale
        if k <= MAX_K and kernel == "v4":
            q8, q_scale = quantize_queries_int8(qf)
            sc, ids = fused_topk_block_plain(q8, sh.passages, n, k)
            sc = sc * (q_scale[:, None] / 127.0)
        else:
            sc, ids = fused_topk_block_plain(qf, sh.passages, n, k)
        parts.append((sc, torch.where(ids >= 0, ids + sh.base, -1)))
    return merge_lists(parts, k)


def check_mesh_counts(c, nonempty: int, k: int, kernel: str, what: str) -> None:
    """One sharded search: each v4 kernel once on each non-empty shard (a
    v3 fallback adds row 2), the v3 kernel once a shard with kernel="v3",
    no kernel past k 128, and no plain twin."""
    from haconvdr_torch.ops.fused_topk import MAX_K

    check_counts(c, [], what)
    v4, v3 = c["topk_v4"], c["fused_topk"]["kernel"]
    if k > MAX_K:  # the plain path
        ok = v3 == 0 and v4["window"] == v4["rescore"] == v4["select"] == 0
    elif kernel == "v4":
        ok = (v4["window"] == v4["rescore"] == v4["select"] == nonempty
              and v4["select_t"] >= nonempty and v3 == v4["v3_fallback"])
    else:
        ok = v3 == nonempty and v4["window"] == 0
    check(ok, f"{what}: launches {json.dumps({'topk_v4': v4, 'fused_topk': v3})} for "
          f"{nonempty} non-empty shards")


def mesh_flat(seed, dev, mesh, rows, queries, total, card: str):
    """(a) The flat index on the mesh in each dtype against the one-shard
    index (float) or the plain per-shard int8 scoring; search ms beside
    the one-shard search's (context)."""
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    from haconvdr_torch.ops.fused_topk import MAX_K

    out = {"build_s": {}, "ms": {}, "bits_equal_where_not_asserted": {}, "v3_fallbacks": {}}
    for name in ("float32", "bfloat16", "int8"):
        t = time.perf_counter()
        one = ShardedIndex.from_tensor(rows, dtype=None if name == "float32" else name)
        idx = ShardedIndex(mesh, rows, dtype=name)
        torch.cuda.synchronize()
        out["build_s"][name] = time.perf_counter() - t
        sizes = [sh.passages.shape[0] for sh in idx.shards]
        check(sum(sizes) == N_ROWS and len(sizes) == MESH_SLOTS, f"mesh {name}: shards {sizes}")
        nonempty = sum(1 for n in sizes if n)
        bits = []
        out["v3_fallbacks"][name] = {}
        for Q in MESH_QS:
            q = queries[:Q]
            for k, kernel in MESH_CASES:
                idx.kernel = one.kernel = kernel
                what = f"mesh {name} Q {Q} k {k} {kernel}"
                zero_counts()
                got = idx.search_device(q, k)
                torch.cuda.synchronize()
                c = read_counts()
                add_counts(total, c)
                check_mesh_counts(c, nonempty, k, kernel, what)
                if kernel == "v4" and k <= MAX_K:  # shards past the budget, of nonempty
                    out["v3_fallbacks"][name][Q] = c["topk_v4"]["v3_fallback"]
                if name == "int8":
                    ref = merged_int8_plain(idx, q, k, kernel)
                else:
                    ref = one.search_device(q, k)
                s, i = (x.cpu() for x in got)
                rs, ri = (x.cpu() for x in ref)
                # the kernels' float scores are one fmaf chain a row, as the
                # one-shard index's; int8 x int8 is exact; the plain path's
                # GEMMs and the int8 v3 kernel against the plain GEMM sum in
                # another order
                if k <= MAX_K and (name != "int8" or kernel == "v4"):
                    compare_exact(s, i, rs, ri, what)
                else:
                    compare_topk(s, i, rs, ri, what)
                    bits.append(torch.equal(s, rs) and torch.equal(i, ri))
        out["bits_equal_where_not_asserted"][name] = all(bits)
        idx.kernel = one.kernel = "v4"
        out["ms"][name] = {}
        for Q in MESH_TIMED_QS:
            out["ms"][name][Q] = {}
            for label, index in (("sharded", idx), ("one_shard", one)):
                def fn(index=index, Q=Q):
                    return index.search_device(queries[:Q], TOP_K)
                _, dev_ms, ops = profiled_ms(fn, 10)
                out["ms"][name][Q][label] = {"events": cuda_ms(fn, 10), "device": dev_ms,
                                             "device_ops": ops}
        del one, idx
        torch.cuda.empty_cache()
    print(f"mesh flat: {MESH_SLOTS} slots of {N_ROWS} x {DIM} rows ({sizes} a shard) in "
          f"float32, bfloat16 and int8 at Q {list(MESH_QS)}, k {TOP_K} (v4, v3) and 300: float "
          f"answers equal the one-shard index's and int8 the per-shard plain scoring's, bit for "
          f"bit through the kernels (int8: the v4 search); k 300 and int8 v3 within the top-k "
          f"rule, bit for bit too: {json.dumps(out['bits_equal_where_not_asserted'])}; shards "
          f"that fell back to v3 a v4 search by Q: {json.dumps(out['v3_fallbacks'])} [{card}]")
    for name, m in out["ms"].items():
        print(f"mesh search {name} k {TOP_K} v4, ms as events / profiler device (device "
              "operations a call), sharded against one shard: " + "; ".join(
                  f"Q {Q} {v['sharded']['events']:.3f} / {v['sharded']['device']:.3f} "
                  f"({v['sharded']['device_ops']:.0f}) against {v['one_shard']['events']:.3f} / "
                  f"{v['one_shard']['device']:.3f} ({v['one_shard']['device_ops']:.0f})"
                  for Q, v in m.items()) + f" [{card}]")
    return out


def mesh_retriever(seed, dev, mesh, params, cfg, rows, total, card: str):
    """(c) Retriever on the mesh over the flat f32 rows: MESH_BATCHED
    concurrent requests through BatchingRetriever(max_batch=64) and single
    ones; each answer equals its dispatch run again (``DispatchLog``), and
    holds phase 12's rule against the one-slot Retriever's sequential
    answer."""
    from haconvdr_torch.config import DataConfig, SearchConfig
    from haconvdr_torch.serve import Retriever
    from haconvdr_torch.utils.testing import HashTokenizer

    r4 = Retriever(HashTokenizer(cfg.vocab_size), params, cfg, rows,
                   data_cfg=DataConfig(is_train=False, use_PRL=False),
                   search_cfg=SearchConfig(top_k=TOP_K, per_device_test_batch_size=64),
                   mesh=mesh)
    check(len(r4.index.shards) == MESH_SLOTS, "mesh retriever: the index is not sharded")
    reqs = make_requests(seed, MESH_BATCHED + N_SINGLE)
    search_qs = []
    search = r4.search

    def recording_search(queries, k=None):
        search_qs.append(int(np.asarray(queries).shape[0]))
        return search(queries, k)

    r4.search = recording_search
    r4.retrieve(*reqs[-1])  # warm-up
    search_qs.clear()
    log = DispatchLog(r4)
    zero_counts()
    answers, metrics = serve(r4, reqs[:MESH_BATCHED], reqs[MESH_BATCHED:])
    c = read_counts()
    log.close()
    r4.search = search
    add_counts(total, c)
    check_counts(c, [("fused_attention", "kernel"), ("topk_v4", "window"),
                     ("topk_v4", "select_t"), ("topk_v4", "select"), ("topk_v4", "rescore")],
                 "mesh retriever")
    examples = [r4.build_query(*r) for r in reqs]
    rerun = log.rerun()
    metrics["padded_score_err"] = log.against_padded("mesh retriever")
    one = build_retriever(params, cfg, dev, rows, None)
    max_norm = float(rows.norm(dim=1).max())
    deltas, drifts, seps = [], [], []
    for j, ans in enumerate(answers):
        match = [q for q, hits in rerun[DispatchLog.key(examples[j]["conv_qp"])]
                 if hits == ans]
        check(len(ans) == TOP_K and bool(match),
              f"mesh retriever: request {j} equals no run of its dispatch")
        ref = one.retrieve(*reqs[j], k=TOP_K + 1)
        q1 = one.embed([examples[j]])[0]
        drift = float(np.linalg.norm(match[0] - q1))
        rel = drift / float(np.linalg.norm(q1))
        check(rel <= 1e-5, f"mesh retriever: request {j}: the slot embedding is {rel:.3g} of "
              "its norm from the one-slot batch-1 one (limit 1e-5)")
        delta = drift * max_norm
        s, rs = np.array([x for _, x in ans]), np.array([x for _, x in ref])
        check(bool((np.abs(s - rs[:TOP_K]) <= 1e-4 * np.abs(rs[:TOP_K]) + delta).all()),
              f"mesh retriever: request {j}: scores beyond 1e-4 rel + {delta:.3g}")
        gap = np.abs(np.diff(rs)) > 1e-5 * np.abs(rs[1:]) + 2 * delta
        sep = np.concatenate([[True], gap[:-1]]) & gap
        check(sep.sum() >= TOP_K // 2 and np.array_equal(
            np.array([p for p, _ in ans])[sep], np.array([p for p, _ in ref[:TOP_K]])[sep]),
              f"mesh retriever: request {j}: ids differ from the one-slot answer at separated "
              "scores")
        deltas.append(delta)
        drifts.append(rel)
        seps.append(int(sep.sum()))
    metrics.update(tower_calls=len(log.runs), delta_max=max(deltas), drift_max=max(drifts),
                   separated_min=min(seps))
    print(f"mesh retriever: {len(answers)} answers ({MESH_BATCHED} concurrent, "
          f"{N_SINGLE} single) each equal their dispatch run again ({len(log.runs)} tower "
          f"calls), bit for bit; against the one-slot Retriever within "
          f"delta <= {max(deltas):.3g} (drift <= {max(drifts):.3g}), ids equal at >= "
          f"{min(seps)} of {TOP_K} ranks")
    print("mesh retriever e2e:", json.dumps(metrics), f"[{card}]")
    del r4, one
    torch.cuda.empty_cache()
    return metrics


def mesh_from_store_and_ivf(seed, dev, mesh, tmp, s13, total, card: str):
    """(a) from_store(mesh, ...) of phase 13's store against the tensor build;
    (b) build_ivf_from_store on the mesh against phase 13's one-shard build,
    full probe against the flat bf16 search, a 4-shard save reloaded onto
    one slot and onto the mesh."""
    import shutil

    from haconvdr_torch.index import ivf
    from haconvdr_torch.index.store import EmbeddingBlockStore
    from haconvdr_torch.parallel.mesh import make_mesh
    from haconvdr_torch.parallel.sharded_ivf import (
        ShardedIVFIndex,
        build_ivf_from_store,
        load_ivf_sharded,
        save_ivf_sharded,
        sharded_ivf_search_device,
    )
    from haconvdr_torch.parallel.sharded_search import ShardedIndex

    out = {}
    rows, mq = ivf_corpus(seed, dev)  # phase 13's rows, regenerated from the seed
    store = EmbeddingBlockStore(f"{tmp}/emb")
    # float32 only: int8 quantizes each shard on the host with numpy, ~4 s a
    # 655,360-row shard; tests/test_torch_cuda.py holds the card's quantize
    # (the tensor build's) to the host's
    t = time.perf_counter()
    fs = ShardedIndex.from_store(mesh, store)
    torch.cuda.synchronize()
    out["from_store_s"] = time.perf_counter() - t
    tb = ShardedIndex(mesh, rows)
    for a, b in zip(fs.shards, tb.shards):
        check(a.base == b.base and torch.equal(a.passages, b.passages),
              "mesh from_store: a shard differs from the tensor build's")
    zero_counts()
    s, i = fs.search_device(mq[:64], TOP_K)
    c = read_counts()
    add_counts(total, c)
    check_mesh_counts(c, MESH_SLOTS, TOP_K, "v4", "mesh from_store")
    rs, ri = tb.search_device(mq[:64], TOP_K)
    compare_exact(s, i, rs, ri, "mesh from_store")
    del fs, tb
    torch.cuda.empty_cache()
    print(f"mesh from_store: phase 13's store into {MESH_SLOTS} float32 slots in "
          f"{out['from_store_s']:.2f} s, streamed into the shards that own its rows; every "
          f"shard and answer equals the tensor build's bit for bit [{card}]")

    one = load_ivf_sharded(f"{tmp}/ivf", device=dev)  # phase 13's one-shard build
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx = build_ivf_from_store(mesh, store, nlist=IVF_NLIST, nprobe=IVF_NPROBE,
                               dtype="bfloat16", seed=seed)
    torch.cuda.synchronize()
    out["ivf_build_s"] = {"slots_4": time.perf_counter() - t, "slots_1": s13["build_s"]}
    check(isinstance(idx, ShardedIVFIndex) and idx.n_shards == MESH_SLOTS,
          "mesh ivf: the build is not sharded")
    check(torch.equal(idx.centroids, one.centroids), "mesh ivf: centroids differ from the "
          "one-shard build's (the same seed and strided sample)")
    per = IVF_NLIST // MESH_SLOTS
    for s_, sh in enumerate(idx.shards):
        check(torch.equal(sh.buckets, one.buckets[s_ * per : (s_ + 1) * per])
              and torch.equal(sh.bucket_ids, one.bucket_ids[s_ * per : (s_ + 1) * per]),
              f"mesh ivf: shard {s_}'s clusters differ from the one-shard build's")
    tail = torch.cat([sh.tail_ids for sh in idx.shards])
    check(torch.equal(tail[tail >= 0].sort().values,
                      one.tail_ids[one.tail_ids >= 0].sort().values),
          "mesh ivf: the shards' tails hold other rows than the one-shard tail")
    q = mq[:64]
    s, i = sharded_ivf_search_device(idx, q, TOP_K, IVF_NPROBE)
    rs, ri = ivf.ivf_search_device(one, q, TOP_K, IVF_NPROBE)
    compare_topk(s.cpu(), i.cpu(), rs.cpu(), ri.cpu(), "mesh ivf: against the one-shard build")
    out["ivf_bits_equal_one_shard"] = bool(torch.equal(s, rs) and torch.equal(i, ri))
    flat16 = ShardedIndex.from_tensor(rows, dtype="bfloat16")
    fs_, fi_ = flat16.search_device(mq[:IVF_FULL_Q], TOP_K)
    s, i = sharded_ivf_search_device(idx, mq[:IVF_FULL_Q], TOP_K, IVF_NLIST)
    compare_topk(s.cpu(), i.cpu(), fs_.cpu(), fi_.cpu(),
                 "mesh ivf: nprobe = nlist against the flat bf16 search")
    del flat16, rows, one
    shutil.rmtree(f"{tmp}/ivf")  # phase 13's build: room for the 4-shard save
    torch.cuda.empty_cache()
    t = time.perf_counter()
    save_ivf_sharded(idx, f"{tmp}/ivf4")
    out["ivf_save_s"] = time.perf_counter() - t
    with open(f"{tmp}/ivf4/ivf_sharded_meta.json") as f:
        meta = json.load(f)
    check(meta["n_shards"] == MESH_SLOTS and meta["corpus_rows"] == N_ROWS,
          f"mesh ivf: saved meta {meta}")
    s4, i4 = sharded_ivf_search_device(idx, q, TOP_K, IVF_NPROBE)
    del idx
    torch.cuda.empty_cache()
    for n in (1, MESH_SLOTS):
        t = time.perf_counter()
        back = load_ivf_sharded(f"{tmp}/ivf4", mesh=make_mesh(devices=[dev] * n))
        torch.cuda.synchronize()
        out[f"ivf_load_{n}_s"] = time.perf_counter() - t
        if n == 1:
            s, i = ivf.ivf_search_device(back, q, TOP_K, IVF_NPROBE)
        else:
            s, i = sharded_ivf_search_device(back, q, TOP_K, IVF_NPROBE)
        out[f"ivf_reload_{n}_bits_equal"] = bool(torch.equal(s, s4) and torch.equal(i, i4))
        if n == MESH_SLOTS:
            check(out[f"ivf_reload_{n}_bits_equal"], "mesh ivf: the 4-slot reload answers "
                  "differ from the build's")
        else:
            compare_topk(s.cpu(), i.cpu(), s4.cpu(), i4.cpu(), "mesh ivf: the 1-slot reload")
        del back
        torch.cuda.empty_cache()
    print(f"mesh ivf: build_ivf_from_store on {MESH_SLOTS} slots (nlist {IVF_NLIST}, bfloat16) "
          f"{out['ivf_build_s']['slots_4']:.2f} s against phase 13's one-slot build "
          f"{out['ivf_build_s']['slots_1']} s; centroids and each shard's clusters equal the "
          f"one-shard build's, its answers at nprobe {IVF_NPROBE} within the top-k rule (bit for "
          f"bit: {out['ivf_bits_equal_one_shard']}), at nprobe {IVF_NLIST} the flat bf16 "
          f"search's; save {out['ivf_save_s']:.2f} s, reload onto 1 slot "
          f"{out['ivf_load_1_s']:.2f} s (bit for bit: {out['ivf_reload_1_bits_equal']}) and "
          f"onto {MESH_SLOTS} {out[f'ivf_load_{MESH_SLOTS}_s']:.2f} s (bit for bit) [{card}]")
    return out


def mesh_two_processes(seed, tmp, total, card: str):
    """(d) Two ranks on the one card, a gloo group for barriers only: the
    per-process IVF save / load round trip and the stride corpus encode
    through the int8 bf16 tower (tests/mp_worker.py); rank 0 stitches the
    strides and holds them to a single-pass encode bit for bit."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), "--seed", str(seed), "--mp-child",
         str(rank), str(MP_WORLD), str(port), tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(HERE))
        for rank in range(MP_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError("mesh two processes: a child timed out:\n" + "\n---\n".join(outs))
    secs = time.perf_counter() - t
    for rank, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"mesh child rank={rank}: OK" in text,
              f"mesh two processes: rank {rank} exited {p.returncode}:\n{text[-4000:]}")
        line = next(x for x in text.splitlines() if x.startswith("mesh child counts:"))
        add_counts(total, json.loads(line.split(":", 1)[1]))
        print("\n".join(x for x in text.splitlines() if x.startswith("mesh child")))
    print(f"mesh two processes: {MP_WORLD} ranks on the one card (gloo barriers), the IVF "
          f"save / load round trip and the stride encode of {N_CORPUS} passages, stitched equal "
          f"to the single pass bit for bit, in {secs:.1f} s (both children's start included) "
          f"[{card}]")
    return secs


def mp_child(seed: int, rank: int, world: int, port: str, tmp: str) -> int:
    """One rank of phase 14 (d); prints its launch counts and OK."""
    import torch.distributed as dist

    from haconvdr_torch.device import resolve_device
    from haconvdr_torch.index.build import encode_corpus
    from haconvdr_torch.index.ivf import IVFIndex
    from haconvdr_torch.index.store import (
        EmbeddingBlockStore,
        TokenizedCorpus,
        TokenizedCorpusWriter,
    )
    from haconvdr_torch.models.convert import init_params_numpy
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params
    from haconvdr_torch.parallel import sharded_ivf
    from haconvdr_torch.parallel.mesh import make_mesh

    dev = resolve_device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    # the per-process IVF round trip (tests/mp_worker.py:36-99), on the card
    rs = np.random.RandomState(0)
    nlist, cap, D, R = 8, 4, 16, 6
    truth = dict(buckets=rs.randn(nlist, cap, D).astype(np.float32),
                 bucket_ids=rs.permutation(nlist * cap).astype(np.int32).reshape(nlist, cap),
                 tail=rs.randn(R, D).astype(np.float32),
                 tail_ids=(1000 + np.arange(R)).astype(np.int32),
                 centroids=rs.randn(nlist, D).astype(np.float32))
    truth["bucket_ids"][0, 2:] = -1
    whole = IVFIndex(nprobe=4, **{k: torch.from_numpy(v).to(dev) for k, v in truth.items()})
    mesh = make_mesh(devices=[dev])
    index = sharded_ivf.shard_ivf(mesh, whole, distributed=True)
    sharded_ivf.save_ivf_sharded(index, f"{tmp}/ivf_mp")
    back, meta = sharded_ivf.load_ivf_sharded(f"{tmp}/ivf_mp", with_meta=True, mesh=mesh,
                                              distributed=True)
    check(meta["n_shards"] == world and meta["corpus_rows"]
          == int((truth["bucket_ids"] >= 0).sum()) + R, f"rank {rank}: meta {meta}")
    per, rows = nlist // world, R // world
    (sh,) = back.shards
    for name, lo, hi in (("buckets", rank * per, (rank + 1) * per),
                         ("bucket_ids", rank * per, (rank + 1) * per),
                         ("tail", rank * rows, (rank + 1) * rows),
                         ("tail_ids", rank * rows, (rank + 1) * rows)):
        check(np.array_equal(getattr(sh, name).cpu().numpy(), truth[name][lo:hi]),
              f"rank {rank}: {name} did not round-trip")
    print(f"mesh child rank={rank}: the IVF shard round-trips through {world} processes")

    # the stride corpus encode through the int8 bf16 tower (tests/mp_worker.py:102-186)
    cfg = model_config()
    params = quantize_encoder_params(init_params_numpy(cfg, seed))
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    enc = AnceEncoder.from_jax_params(params, cfg, dev)
    if rank == 0:
        ids, lengths = corpus_tokens(seed, cfg.vocab_size)
        w = TokenizedCorpusWriter(f"{tmp}/corpus", max_seq_length=ENC_LEN)
        w.add_batch(np.arange(N_CORPUS, dtype=np.int64) * 5 + 3, ids, lengths)
        w.finalize()
    dist.barrier()
    corpus = TokenizedCorpus(f"{tmp}/corpus")
    kw = dict(batch_size=ENC_BATCH, per_block_passage_num=ENC_BLOCK)
    per_rank_blocks = -(-(-(-N_CORPUS // world)) // ENC_BLOCK)
    zero_counts()
    n_fwd = [0]

    def counted(ids_t, mask_t):
        n_fwd[0] += 1
        return enc(ids_t, mask_t)

    t = time.perf_counter()
    encode_corpus(corpus, counted, f"{tmp}/shared", stride=world, offset=rank,
                  start_block_id=rank * per_rank_blocks, device=dev, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = read_counts()
    check_counts(counts, [("fused_attention", "kernel"), ("fused_ln", "ln_quant"),
                          ("fused_mlp", "kernel")], f"rank {rank} encode")
    check_tower_counts(counts, n_fwd[0], cfg.num_hidden_layers, f"rank {rank} encode")
    print("mesh child counts:", json.dumps(counts))
    print(f"mesh child rank={rank}: encoded its stride in {secs:.3f} s ({n_fwd[0]} forwards)")
    dist.barrier()
    if rank == 0:
        encode_corpus(corpus, enc, f"{tmp}/single", device=dev, **kw)

        def id_map(path):
            store, got = EmbeddingBlockStore(path), {}
            for b in range(store.num_blocks()):
                emb, offs = store.read_block(b)
                for row, off in zip(np.asarray(emb), np.asarray(offs)):
                    check(int(off) not in got, f"offset {off} written twice")
                    got[int(off)] = row
            return got

        single, stitched = id_map(f"{tmp}/single"), id_map(f"{tmp}/shared")
        check(set(single) == set(stitched) and len(single) == N_CORPUS,
              "the strides do not cover the corpus once")
        check(all(np.array_equal(single[o], stitched[o]) for o in single),
              "a stitched row differs from the single-pass encode")
        print(f"mesh child rank=0: {len(single)} stitched rows equal the single pass bit for bit")
    dist.barrier()
    dist.destroy_process_group()
    print(f"mesh child rank={rank}: OK", flush=True)
    return 0


def phase_mesh(seed: int, dev, params, cfg, p_sum: float, tmp: str, s13: dict, card: str):
    """Phase 14: the multi-device layer as MESH_SLOTS shard slots on the one
    card: (a) the flat index, (b) the IVF index, (c) the Retriever and
    BatchingRetriever on the mesh, (d) two processes."""
    import tempfile

    from haconvdr_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[dev] * MESH_SLOTS)
    total = {}
    stages = {}
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn(N_ROWS, DIM, device=dev, generator=g)  # phase 4's rows
    check(float(rows.sum(dtype=torch.float64)) == p_sum,
          "mesh: the regenerated rows differ from phase 4's")
    queries = torch.randn(max(MESH_QS), DIM, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed + 14))
    stages["flat"] = mesh_flat(seed, dev, mesh, rows, queries, total, card)
    stages["retriever"] = mesh_retriever(seed, dev, mesh, params, cfg, rows, total, card)
    del rows, queries
    torch.cuda.empty_cache()
    stages["store_ivf"] = mesh_from_store_and_ivf(seed, dev, mesh, tmp, s13, total, card)
    with tempfile.TemporaryDirectory(dir=tmp) as mp_tmp:
        stages["two_process_s"] = mesh_two_processes(seed, mp_tmp, total, card)
    stages["seconds"] = time.perf_counter() - t_phase
    print("mesh launch counts:", json.dumps(total))
    check_counts(total, [("fused_attention", "kernel"), ("fused_topk", "kernel"),
                         ("topk_v4", "window"), ("topk_v4", "select_t"), ("topk_v4", "rescore"),
                         ("topk_v4", "select"), ("fused_ln", "ln_quant"), ("fused_mlp", "kernel")],
                 "mesh")
    print("mesh e2e:", json.dumps(stages), f"[{card}]")
    return total, stages


# ---------------------------------------------------------------------------
# phase 15: training on a mesh and the tensor-parallel encode
# ---------------------------------------------------------------------------

OFFSET_ROWS = (16, 32)  # phase 15b: the second of four B 16 slots of phase 9's B 64
TP_F32_REL = 1e-4  # the f32 tp encode against the un-split tower (JAX's tests/test_parallel.py)


def mesh_devices(dev):
    """MESH_SLOTS slots of the one card, or every visible card."""
    n = torch.cuda.device_count()
    return [dev] * MESH_SLOTS if n == 1 else [torch.device("cuda", i) for i in range(n)]


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).double() for t in tensors])


def mesh_train(seed: int, dev, devices, phase9: dict, card: str):
    """(a) phase 9's geometry on the mesh against one slot: the same state,
    batches and dropout generator; two micro steps (accumulation 2: one
    update); then, on each in turn, TRAIN_MICRO timed micro steps and one
    profiled accumulation window (its idle share)."""
    from haconvdr_torch.config import TrainConfig

    # phase 9's tower: dropout 0.1 (the defaults)
    cfg = dataclasses.replace(model_config(), dtype="bfloat16", remat="mlp")
    n = len(devices)
    tcfg = TrainConfig(per_device_train_batch_size=TRAIN_B // n, accumulation_steps=TRAIN_ACC,
                       learning_rate=TRAIN_LR, num_warmup_portion=0.0, weight_decay=0.01,
                       max_grad_norm=1.0, is_pseudo_prepos=True, is_prepos_neg=True,
                       frozen_dtype="int8")
    L, n_frozen = cfg.num_hidden_layers, 4
    batches = [train_batch(seed + 150 + i, TRAIN_B, cfg.vocab_size) for i in range(2)]
    got, counts = {}, {}
    for run, devs in (("one slot", [dev]), ("mesh", devices)):
        step, state, frozen = train_setup(seed + 150, dev, cfg, tcfg, rng_seed=seed + 152,
                                          devices=devs)
        init = flat(state.model.parameters())
        zero_counts()
        _, l1 = step(state, frozen, batches[0])
        g1 = flat(state.accum_grads.values())
        _, l2 = step(state, frozen, batches[1])
        c = read_counts()
        check(state.global_step == 1, f"mesh training ({run}): no update after two micro steps")
        check_train_counts(c, L, n_frozen, 2 * len(devs), what=f"mesh training ({run})")
        params = flat(state.model.parameters())
        same = all(torch.equal(p, q.to(p.device)) for r in state.replicas[1:]
                   for p, q in zip(state.model.parameters(), r.parameters()))
        check(same, f"mesh training ({run}): the replicas differ after the update")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        zero_counts()
        for _ in range(TRAIN_MICRO):
            t = time.perf_counter()
            _, loss = step(state, frozen, batches[0])
            float(loss)  # a host sync: the step has finished
            secs.append(time.perf_counter() - t)
        timed_counts = read_counts()
        check_train_counts(timed_counts, L, n_frozen, TRAIN_MICRO * len(devs),
                           what=f"mesh training ({run})")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        wall_ms, dev_ms, _ = profile_window(lambda: step(state, frozen, batches[0]), TRAIN_ACC)
        add_counts(counts, c)
        add_counts(counts, timed_counts)
        timed = secs[TRAIN_WARM:]
        got[run] = dict(loss=[float(l1), float(l2)], grads=g1, update=params - init,
                        params=params, replicas=len(state.replicas), replicas_equal=same,
                        examples_per_s=TRAIN_B * len(timed) / sum(timed),
                        examples_per_s_median_step=TRAIN_B / float(np.median(timed)),
                        micro_step_ms=[x * 1e3 for x in secs], peak_memory_gib=peak_gib,
                        profiled_wall_ms=wall_ms, device_ms=dev_ms,
                        idle_share=1.0 - dev_ms / wall_ms)
        del step, state, frozen
        torch.cuda.empty_cache()
    one, mesh = got["one slot"], got["mesh"]
    loss_ok = all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b) for a, b in zip(mesh["loss"], one["loss"]))
    grad_rel = float((mesh["grads"] - one["grads"]).norm() / one["grads"].norm())
    param_rel = float((mesh["params"] - one["params"]).norm() / one["params"].norm())
    update_rel = float((mesh["update"] - one["update"]).norm() / one["update"].norm())
    check(loss_ok and grad_rel <= TRAIN_GRAD_REL and update_rel <= TRAIN_GRAD_REL,
          f"mesh training: mesh vs one slot: losses {mesh['loss']} vs {one['loss']}, "
          f"gradients {grad_rel} apart, the update {update_rel} apart")
    keys = ("examples_per_s", "examples_per_s_median_step", "micro_step_ms", "peak_memory_gib",
            "profiled_wall_ms", "device_ms", "idle_share")
    metrics = dict(slots=n, cards=len({str(d) for d in devices}), losses_mesh=mesh["loss"],
                   losses_one_slot=one["loss"], grad_rel=grad_rel, param_rel=param_rel,
                   update_rel=update_rel, replicas=mesh["replicas"],
                   replicas_equal=mesh["replicas_equal"],
                   mesh={k: mesh[k] for k in keys}, one_slot={k: one[k] for k in keys},
                   phase9_examples_per_s=phase9.get("examples_per_s"))
    print(f"mesh training (a): B {TRAIN_B} on {n} dp slots of {TRAIN_B // n} against one slot "
          f"(phase 9's geometry, dropout 0.1, the same generator): losses "
          f"{', '.join(f'{x:.6f}' for x in mesh['loss'])} vs "
          f"{', '.join(f'{x:.6f}' for x in one['loss'])}; gradients {grad_rel:.3e} apart, "
          f"the update {update_rel:.3e} apart (params after it {param_rel:.3e}); "
          f"{mesh['replicas']} replica(s), bit-equal: {mesh['replicas_equal']}; examples/s "
          f"mesh {mesh['examples_per_s']:.2f} (median step {mesh['examples_per_s_median_step']:.2f}, "
          f"idle {mesh['idle_share']:.1%}) against one slot {one['examples_per_s']:.2f} (median "
          f"step {one['examples_per_s_median_step']:.2f}, idle {one['idle_share']:.1%}) in this "
          f"phase, phase 9's {phase9.get('examples_per_s', float('nan')):.2f} [{card}]")
    return counts, metrics


def mesh_row_offset(seed: int, dev, card: str):
    """(b) rows 11-12 on rows OFFSET_ROWS of phase 9's B 64 batch (bf16) and
    phase 11's (f32), row_offset = the slice's first row: bit for bit
    against those rows of the whole-batch launch (output, row stats,
    dqkv), and against the plain twins with the same offset at rows
    11-12's tolerances."""
    from haconvdr_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed + 160)
    rng = np.random.default_rng(seed + 160)
    lengths = rng.integers(TRAIN_QLEN // 8, TRAIN_QLEN + 1, TRAIN_B)
    mask = torch.from_numpy(
        (np.arange(TRAIN_QLEN)[None, :] < lengths[:, None]).astype(np.int32)).to(dev)
    seed_words = fa.draw_seed(torch.Generator().manual_seed(seed + 161))
    a, b = OFFSET_ROWS
    out = {}
    for dt, config in ((torch.bfloat16, FLASH_MAIN), (torch.float32, FLASH_F32)):
        qkv = (torch.randn(TRAIN_B, TRAIN_QLEN, 3 * DIM, device=dev, generator=g) * 0.5).to(dt)
        go = torch.randn(TRAIN_B, TRAIN_QLEN, DIM, device=dev, generator=g).to(dt)
        with torch.no_grad():
            whole, stats = fa._fwd_kernel(qkv, mask, 12, seed_words, 0.1)
            dq = fa._bwd_kernel(qkv, mask, stats, go, 12, seed_words, 0.1)
            sq, sm, sg = qkv[a:b].contiguous(), mask[a:b].contiguous(), go[a:b].contiguous()
            o, st = fa._fwd_kernel(sq, sm, 12, seed_words, 0.1, a)
            d = fa._bwd_kernel(sq, sm, st, sg, 12, seed_words, 0.1, a)
            torch.cuda.synchronize()
            check(torch.equal(o, whole[a:b]) and torch.equal(st, stats[a:b])
                  and torch.equal(d, dq[a:b]),
                  f"flash row offset {config}: rows {a}:{b} differ from the whole batch's")
            o0, _ = fa._fwd_kernel(sq, sm, 12, seed_words, 0.1)
            check(not torch.equal(o0, whole[a:b]),
                  f"flash row offset {config}: offset 0 drew the same masks")
            ref = fa.flash_attention_fwd_plain(sq, sm, 12, seed_words, 0.1, a)
            rdq = fa.flash_attention_bwd_plain(sq, sm, sg, 12, seed_words, 0.1, a)
            errs = []
            for got_, want, what in ((o, ref, "forward"), (d, rdq, "dqkv")):
                err = float((got_.float() - want.float()).abs().max())
                tol = 1e-5 if dt == torch.float32 else bf16_ulp_of_max(want)
                check(err <= tol, f"flash row offset {what} {config}: {err} > {tol}")
                errs.append(err)
            if dt == torch.bfloat16:
                check_dqkv_parts(d, rdq, f"flash row offset dqkv {config}")
            fwd_ms = cuda_ms(lambda: fa._fwd_kernel(sq, sm, 12, seed_words, 0.1, a), ATTN_REPS)
            bwd_ms = cuda_ms(lambda: fa._bwd_kernel(sq, sm, st, sg, 12, seed_words, 0.1, a), 10)
            fwd0 = cuda_ms(lambda: fa._fwd_kernel(sq, sm, 12, seed_words, 0.1), ATTN_REPS)
            bwd0 = cuda_ms(lambda: fa._bwd_kernel(sq, sm, st, sg, 12, seed_words, 0.1), 10)
            pf = cuda_ms(lambda: fa.flash_attention_fwd_plain(sq, sm, 12, seed_words, 0.1, a), 3)
            pb = cuda_ms(
                lambda: fa.flash_attention_bwd_plain(sq, sm, sg, 12, seed_words, 0.1, a), 3)
        name = "float32" if dt == torch.float32 else "bfloat16"
        isz, peak = qkv.element_size(), PEAK_OF[name]
        ops = 3 if peak == "f32" else 1
        peak = "tf32" if peak == "f32" else peak
        sl = lengths[a:b]
        fb = bound(ops * attention_flops(sl, TRAIN_QLEN, DIM, 2),
                   (b - a) * TRAIN_QLEN * (4 * DIM * isz + 4), peak)
        bb = bound(ops * attention_flops(sl, TRAIN_QLEN, DIM, 5),
                   (b - a) * TRAIN_QLEN * (7 * DIM * isz + 4), peak)
        out[name] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_ms_offset0=fwd0, bwd_ms_offset0=bwd0,
                         plain_fwd_ms=pf, plain_bwd_ms=pb, fwd_bound_ms=fb[0],
                         bwd_bound_ms=bb[0], max_abs_err=errs)
        print(f"mesh row offset (b) [{config}, rows {a}:{b}, row_offset {a}]: bit for bit "
              f"against the whole batch's rows; forward {fwd_ms:.4f} ms (offset 0 "
              f"{fwd0:.4f}), plain {pf:.4f} ms, bound {fb[0]:.5f} ms ({fb[1]}); backward "
              f"{bwd_ms:.4f} ms (offset 0 {bwd0:.4f}), plain {pb:.4f} ms, bound {bb[0]:.5f} ms "
              f"({bb[1]}); max |err| vs the twins {errs[0]:.3g}, {errs[1]:.3g} [{card}]")
        del qkv, go, whole, stats, dq, sq, sm, sg, o, st, d, o0, ref, rdq
    torch.cuda.empty_cache()
    return out


def tp_split_mlp(dev, card: str):
    """Row 10's split mode at the corpus-encode rows (98,304), tp 2 and 4:
    bit for bit against the un-split kernel, against its plain twin at
    row 10's bounds; device ms beside the un-split kernel's, plain ms,
    bound (the block's: the split moves no other input or output)."""
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.ops import fused_ln as fl
    from haconvdr_torch.models.encoder import mlp_block_split
    from haconvdr_torch.ops import fused_mlp as fm

    g = torch.Generator(device=dev).manual_seed(170)
    R = ENC_BATCH * ENC_LEN
    xb = (torch.randn(R, DIM, device=dev, generator=g) * 3.0).to(torch.bfloat16)
    lns = torch.randn(DIM, device=dev, generator=g) * 0.5 + 1.0
    lnb = torch.randn(DIM, device=dev, generator=g) * 0.1
    x = fl.fused_residual_ln_plain(xb, None, lns, lnb, 1e-5)
    xq, xs = quantize_rows(x)
    w1, s1 = int8_weight(g, dev, INTER, DIM)
    w2, s2 = int8_weight(g, dev, DIM, INTER)
    b1 = torch.randn(INTER, device=dev, generator=g) * 0.02
    b2 = torch.randn(DIM, device=dev, generator=g) * 0.02
    whole_args = (x, xq, xs, w1, s1, b1, w2, s2, b2, lns, lnb)
    whole = fm.fused_mlp_block(*whole_args, eps=1e-5)
    whole_ms = device_ms(lambda: fm.fused_mlp_block(*whole_args, eps=1e-5), 5)
    fb = bound(4.0 * R * DIM * INTER, R * DIM * 6 + R * 8 + 2 * DIM * INTER, "int8")
    out = {}
    for tp in (2, MESH_SLOTS):
        n = INTER // tp
        sp = (x, xq, xs, [w1[r * n:(r + 1) * n] for r in range(tp)],
              [s1[r * n:(r + 1) * n] for r in range(tp)],
              [b1[r * n:(r + 1) * n] for r in range(tp)],
              [w2[:, r * n:(r + 1) * n].contiguous() for r in range(tp)], s2, b2, lns, lnb)
        run = lambda: mlp_block_split(*sp, eps=1e-5)  # noqa: E731
        plain = lambda: mlp_block_split(*sp, eps=1e-5, plain=True)  # noqa: E731
        zero_counts()  # a check of the kernel, apart from the path's counts
        got = run()
        torch.cuda.synchronize()
        c = read_counts()
        check(c["fused_mlp"]["split_finish"] == 1 and c["fused_mlp"]["split_up"] == tp
              and c["fused_mlp"]["split_down"] == tp,
              f"fused_mlp split tp {tp}: launch counts {c['fused_mlp']}")
        check_counts(c, [], f"fused_mlp split tp {tp}")
        check(all(torch.equal(a, b) for a, b in zip(got, whole)),
              f"fused_mlp split tp {tp}: differs from the un-split kernel")
        ry, rq, _ = plain()
        d = (got[0].float() - ry.float()).abs()
        flips = float((d > 2.0**-6 * (1 + ry.float().abs())).float().mean())
        check(bool((d <= 2.0**-6 * ry.float().abs() + 0.07).all()) and flips < 2e-3,
              f"fused_mlp split tp {tp}: beyond the JAX test's bounds against its twin")
        ms = device_ms(run, 5)
        pms = cuda_ms(plain, 2)
        out[tp] = dict(ms=ms, plain_ms=pms, bound_ms=fb[0], bound_by=fb[1], unsplit_ms=whole_ms,
                       max_abs_err=float(d.max()), flip_share=flips)
        print(f"tp split fused_mlp [bf16, {R} rows, tp {tp} on one card]: {ms:.4f} ms device "
              f"(the un-split block {whole_ms:.4f} ms), plain {pms:.4f} ms, bound {fb[0]:.5f} "
              f"ms ({fb[1]}), ms / bound {ms / fb[0]:.2f}; bit for bit the un-split kernel's "
              f"[{card}]")
        del got, ry, rq, d
    del x, xq, xs, xb, whole
    torch.cuda.empty_cache()
    return out


def tp_encode(seed: int, dev, devices, params, card: str):
    """(c) phase 8's int8 bf16 tower (and the f32 float tower) split over
    the mesh's tp axis, dp 1 x tp n and dp n/2 x tp 2 (shard_params(tp=True)
    through dp_encode_fn), at ENC_BATCH x ENC_LEN: int8 bit for bit the
    un-split tower's on the same dp slices, f32 within TP_F32_REL; launch
    counts of the split path."""
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params
    from haconvdr_torch.parallel import dp_encode_fn, make_mesh, shard_params

    n = len(devices)
    cfg = dataclasses.replace(model_config(), dtype="bfloat16")
    f32 = model_config()
    qparams = quantize_encoder_params(params)
    ids, _ = corpus_tokens(seed, cfg.vocab_size)
    ids = torch.from_numpy(ids[:ENC_BATCH]).to(dev)
    mask = (ids != 0).to(torch.int32)
    mask[:, 0] = 1
    L = cfg.num_hidden_layers
    counts, out = {}, {}
    one = AnceEncoder.from_jax_params(qparams, cfg, dev)
    one32 = AnceEncoder.from_jax_params(params, f32, dev)
    for dp, tp in ((1, n), (n // 2, 2)):
        mesh = make_mesh(dp=dp, tp=tp, devices=devices)
        with torch.inference_mode():
            ref = dp_encode_fn(make_mesh(devices=devices[:dp]), one)(ids, mask)
            ref32 = dp_encode_fn(make_mesh(devices=devices[:dp]), one32)(ids, mask)
            fn = dp_encode_fn(mesh, shard_params(mesh, qparams, tp=True, cfg=cfg))
            fn(ids, mask)  # warm-up
            torch.cuda.synchronize()
            zero_counts()
            t = time.perf_counter()
            got = fn(ids, mask)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            c = read_counts()
            fn32 = dp_encode_fn(mesh, shard_params(mesh, params, tp=True, cfg=f32))
            got32 = fn32(ids, mask)
            one_ms = cuda_ms(lambda: one(ids, mask), 2)
            whole = torch.equal(got, one(ids, mask))
        check(torch.equal(got, ref), f"tp encode dp {dp} x tp {tp}: int8 rows differ from the "
              "un-split tower's")
        rel32 = float((got32 - ref32).abs().max() / ref32.abs().max())
        check(rel32 <= TP_F32_REL, f"tp encode dp {dp} x tp {tp}: f32 {rel32} > {TP_F32_REL}")
        want = {("fused_attention", "kernel"): L * tp * dp, ("fused_ln", "ln_quant"): (1 + L) * dp,
                ("fused_mlp", "split_up"): L * tp * dp, ("fused_mlp", "split_down"): L * tp * dp,
                ("fused_mlp", "split_finish"): L * dp, ("fused_mlp", "kernel"): 0,
                ("int8_dense", "dense"): L * tp * dp, ("int8_dense", "codes"): 0}
        for (mod, key), k in want.items():
            check(c[mod][key] == k, f"tp encode dp {dp} x tp {tp}: {mod} {key} launched "
                  f"{c[mod][key]} times, not {k}")
        check_counts(c, [k for k, v in want.items() if v], f"tp encode dp {dp} x tp {tp}")
        add_counts(counts, c)
        out[f"dp{dp}_tp{tp}"] = dict(seconds=secs, one_slot_ms=one_ms, f32_rel=rel32,
                                     equal_to_whole_batch=whole)
        print(f"tp encode (c) dp {dp} x tp {tp} on {len({str(d) for d in devices})} card(s): "
              f"{ENC_BATCH} x {ENC_LEN} through the int8 bf16 tower in {secs * 1e3:.1f} ms "
              f"(one slot, un-split: {one_ms:.1f} ms), bit for bit the un-split tower's on the "
              f"same dp slices (and the whole batch's: {whole}); f32 tower max |diff| / max "
              f"|ref| {rel32:.3e} [{card}]")
        del got, ref, got32, ref32, fn, fn32
        torch.cuda.empty_cache()
    return counts, out


def phase_mesh_train_tp(seed: int, dev, params, phase9: dict, card: str):
    """Phase 15: (a) training on a mesh, (b) rows 11-12 with a row offset,
    (c) the tensor-parallel encode with row 10's split mode."""
    t_phase = time.perf_counter()
    devices = mesh_devices(dev)
    c_a, train = mesh_train(seed, dev, devices, phase9, card)
    offset = mesh_row_offset(seed, dev, card)
    c_c, enc = tp_encode(seed, dev, devices, params, card)
    split = tp_split_mlp(dev, card)
    secs = time.perf_counter() - t_phase
    counts = {}
    add_counts(counts, c_a)
    add_counts(counts, c_c)
    print("mesh train / tp launch counts:", json.dumps(counts))
    print("mesh train e2e:", json.dumps(dict(train=train, row_offset=offset, tp_encode=enc,
                                             split_mlp=split, seconds=secs)), f"[{card}]")
    print(f"phase 15 (training on a mesh, the tp encode) took {secs:.1f} s [{card}]")
    return counts, dict(split=split, offset=offset)


# ---------------------------------------------------------------------------
# phase 16: the expert layer
# ---------------------------------------------------------------------------

def grouped_mm_ms(x, gate, w13, w2):
    """torch._grouped_mm's ms for the expert layer's two grouped products
    over tokens already sorted by expert (the library yardstick), or None
    where this PyTorch lacks it or refuses the shapes."""
    from haconvdr_torch.ops import moe

    if not hasattr(torch, "_grouped_mm"):
        return None
    _, e = moe.route_plain(x, gate, MOE_K)
    xs = x[torch.argsort(e.flatten()) // MOE_K]
    offs = torch.cumsum(torch.bincount(e.flatten(), minlength=MOE_E), 0).to(torch.int32)

    def lib():
        gt, up = torch._grouped_mm(xs, w13.transpose(1, 2), offs=offs).chunk(2, dim=-1)
        return torch._grouped_mm(F.silu(gt) * up, w2.transpose(1, 2), offs=offs)

    try:
        return cuda_ms(lib, MOE_REPS)
    except RuntimeError:
        return None


def phase_experts(seed: int, dev, card: str):
    """Phase 16: ops.moe.routed_experts (csrc/moe_experts.cu: routing, grouped
    up, grouped down) at the DeepSeek-V2 cell's shape, with the routing of
    random weights (a largest load ~1.1x the mean) and with one expert taking
    about half the tokens (~5x, the cell's reading): each call against the
    plain twin (every row within MOE_REL of its norm), its launches counted
    from zero (three, no twin), the largest load read from the device
    accumulators, device ms, the bound and torch._grouped_mm's ms."""
    from haconvdr_torch.ops import moe

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 16)
    T, H, I, E, K = MOE_T, MOE_H, MOE_I, MOE_E, MOE_K
    gate = (torch.randn(E, H, device=dev, generator=g) * H ** -0.5).to(torch.bfloat16)
    w13 = (torch.randn(E, 2 * I, H, device=dev, generator=g) * H ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn(E, H, I, device=dev, generator=g) * I ** -0.5).to(torch.bfloat16)
    x0 = torch.randn(T, H, device=dev, generator=g)
    row0 = gate[0].float()
    rows, counts = [], {}
    flops = 2.0 * T * K * 3 * H * I
    nbytes = (E * 3 * H * I * 2 + T * H * 2 + T * H * 4  # weights, x, y
              + 2 * T * K * I * 2)  # h written and read
    for name, shift in (("uniform", 0.0), ("skewed", MOE_SHIFT)):
        x = (x0 + shift * row0 / row0.dot(row0)).to(torch.bfloat16)
        moe.routed_experts(x, gate, w13, w2, K)  # warm
        torch.cuda.synchronize()
        zero_counts()
        max0 = moe.device_counts()["max_load_sum"]
        out = moe.routed_experts(x, gate, w13, w2, K)
        torch.cuda.synchronize()
        c = read_counts()
        skew = (moe.device_counts()["max_load_sum"] - max0) / (T * K / E)
        check(c["moe"]["kernel"] == 1 and c["moe"]["launches"] == 3,
              f"experts ({name}): {c['moe']['launches']} launches, not 3")
        check_counts(c, [("moe", "launches")], f"experts ({name})")
        add_counts(counts, c)
        ref = moe.routed_experts_plain(x, gate, w13, w2, K)
        err = (out - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        differ = int((out != ref).sum())
        check(float(err.max()) <= MOE_REL,
              f"experts ({name}): a row {float(err.max()):.3e} of its norm from the twin")
        ms = cuda_ms(lambda: moe.routed_experts(x, gate, w13, w2, K), MOE_REPS)
        plain_ms = cuda_ms(lambda: moe.routed_experts_plain(x, gate, w13, w2, K), 1)
        lib = grouped_mm_ms(x, gate, w13, w2)
        row = dict(kernel="moe_experts", config=f"bf16, {name}", max_abs_err=float(err.max()),
                   ms=ms, plain_ms=plain_ms, library_ms=lib, skew=skew,
                   **bound_row(flops, nbytes, "bf16"))
        rows.append(row)
        print(f"experts {name}: T {T} H {H} I {I} E {E} top {K}, largest load {skew:.2f}x "
              f"the mean; {ms:.3f} ms (plain {plain_ms:.2f} ms, torch._grouped_mm "
              f"{'none' if lib is None else f'{lib:.3f} ms'}), bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}), {100 * row['bound_ms'] / ms:.1f}% of it; max row error "
              f"{float(err.max()):.2e}, {differ} of {out.numel()} elements not the twin's "
              f"[{card}]")
    del gate, w13, w2, x0
    torch.cuda.empty_cache()
    print(f"phase 16 (the expert layer) took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return counts, rows


# ---------------------------------------------------------------------------
# phase 17: the int8 dense
# ---------------------------------------------------------------------------

def phase_int8_dense(seed: int, dev, card: str):
    """Phase 17 (see the module docstring): (counts, rows)."""
    from haconvdr_torch.index.quantize import quantize_rows
    from haconvdr_torch.ops import fused_mlp
    from haconvdr_torch.ops import int8_dense as idn

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    rows, counts = [], {}
    for M in DENSE_ROWS:
        x = (torch.randn(M, DIM, device=dev, generator=g) * 2).to(torch.bfloat16)
        pq = quantize_rows(x)
        for name, N, given in (("qkv", 3 * DIM, True), ("output", DIM, False)):
            w, ks = int8_weight(g, dev, N, DIM)
            b = torch.linspace(-0.1, 0.1, N, device=dev)
            p = pq if given else None

            def run():
                return idn.int8_dense(x, w, ks, b, p, torch.bfloat16)

            run()  # warm
            torch.cuda.synchronize()
            zero_counts()
            y = run()
            torch.cuda.synchronize()
            c = read_counts()
            what = f"int8 dense ({name}, {M} rows)"
            check(c["int8_dense"] == {"dense": 1, "codes": 0 if given else 1, "plain": 0},
                  f"{what}: launches {c['int8_dense']}")
            check_counts(c, [("int8_dense", "dense")], what)
            add_counts(counts, c)
            differ = int((y != idn.int8_dense_plain(x, w, ks, b, p, torch.bfloat16)).sum())
            check(differ == 0, f"{what}: {differ} elements not the twin's")
            ms = device_ms(run, DENSE_REPS)
            plain_ms = device_ms(lambda: idn.int8_dense_plain(x, w, ks, b, p, torch.bfloat16), 5)
            lib = device_ms(lambda: fused_mlp._int_mm(pq[0], w), DENSE_REPS)
            flops = 2.0 * M * N * DIM
            nbytes = M * DIM * (1 if given else 2) + N * DIM + 2.0 * M * N
            row = dict(kernel="int8_dense", config=f"{name}, {M} rows", max_abs_err=0.0, ms=ms,
                       plain_ms=plain_ms, library_ms=lib,
                       **bound_row(flops, nbytes, "int8"))
            rows.append(row)
            print(f"int8 dense {name}: [{M}, {DIM}] x [{N}, {DIM}]^T -> bf16"
                  f"{'' if given else ' (with the codes kernel)'}: "
                  f"{ms:.4f} ms; plain twin (the parent's composition) {plain_ms:.4f} ms; "
                  f"torch._int_mm alone {lib:.4f} ms; bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}), {100 * row['bound_ms'] / ms:.1f}% of it; bit for bit "
                  f"the twin [{card}]")
        del x, pq, w
    torch.cuda.empty_cache()
    print(f"phase 17 (the int8 dense) took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return counts, rows


def dense_entry(launches: int, rows: list) -> dict:
    """Row 14 of the kernels line: the int8 dense's launches over phases
    4-15 and 17, and its times at the encode cell's QKV dense."""
    main_row = next(r for r in rows if r["config"] == f"qkv, {DENSE_ROWS[0]} rows")
    return {"name": "int8_dense", "route": "cuda", "source": "haconvdr_torch/csrc/int8_dense.cu",
            "replaces": None, "launches": launches, "max_abs_err": 0.0,
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["experts", "dense"],
                    help="run phases 1-2 and this phase alone (experts: phase 16; dense: 17)")
    ap.add_argument("--mp-child", nargs=4, metavar=("RANK", "WORLD", "PORT", "DIR"),
                    help="run one rank of phase 14's two processes (the script starts them)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if args.mp_child:
        rank, world, port, tmp = args.mp_child
        return mp_child(args.seed, int(rank), int(world), port, tmp)

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

    if args.only == "experts":
        c16, rows16 = phase_experts(args.seed, dev, card)
        for r in rows16:
            print("kernel vs plain:", json.dumps(r), f"[{card}]")
        print(json.dumps({"kernels": [moe_entry(c16, rows16)]}))
        return finish(t_start, card)
    if args.only == "dense":
        c17, rows17 = phase_int8_dense(args.seed, dev, card)
        for r in rows17:
            print("kernel vs plain:", json.dumps(r), f"[{card}]")
        print(json.dumps({"kernels": [dense_entry(c17["int8_dense"]["dense"], rows17)]}))
        return finish(t_start, card)

    g = torch.Generator(device=dev).manual_seed(args.seed)
    passages = torch.randn(N_ROWS, DIM, device=dev, generator=g)
    codes, scale = quantize_int8_torch(passages)
    rows = phase_kernels(args.seed, dev, passages, codes, scale)
    del codes
    torch.cuda.empty_cache()
    for r in rows:
        print("kernel vs plain:", json.dumps(r), f"[{card}]")
    print_redesigned(rows, card)

    cfg = model_config()
    params = init_params_numpy(cfg, args.seed)
    p_sum = float(passages.sum(dtype=torch.float64))  # phase 12 regenerates these rows
    c4, e2e, queries, served = phase_main_path(args.seed, dev, passages, params, cfg, card)
    c5, e2e8, scale8 = phase_int8_path(args.seed, dev, passages, params, cfg, card)
    check(torch.equal(scale8, scale), "int8 path: index scale differs from quantize_int8_torch")
    c6 = phase_streaming(dev, passages, scale, queries)
    c7, _, _ = phase_int8_tower(args.seed, dev, passages, params, cfg, card)
    del passages
    torch.cuda.empty_cache()
    c8, _ = phase_corpus_encode(args.seed, dev, params, cfg, card)
    c9, m9 = phase_training(args.seed, dev, card)
    c10, _ = phase_offline_eval(args.seed, dev, params, cfg, card)
    c11, _ = phase_train_f32(args.seed, dev, card)
    c12, _ = phase_http(args.seed, dev, params, cfg, served, p_sum, card)
    del served
    import tempfile

    # phase 13's store and build stay for phase 14: store + buckets (< 2x)
    root = room_for(N_ROWS * (DIM * 4 + 8) + 2 * N_ROWS * DIM * 2)
    with tempfile.TemporaryDirectory(dir=root) as work:
        c13, s13 = phase_ivf(args.seed, dev, params, cfg, card, work)
        t14 = time.perf_counter()
        c14, _ = phase_mesh(args.seed, dev, params, cfg, p_sum, work, s13, card)
        print(f"phase 14 (the mesh) took {time.perf_counter() - t14:.1f} s [{card}]")
    c15, _ = phase_mesh_train_tp(args.seed, dev, params, m9, card)
    c16, rows16 = phase_experts(args.seed, dev, card)
    for r in rows16:
        print("kernel vs plain:", json.dumps(r), f"[{card}]")
    c17, rows17 = phase_int8_dense(args.seed, dev, card)
    for r in rows17:
        print("kernel vs plain:", json.dumps(r), f"[{card}]")
    print(f"phases done in {time.perf_counter() - t_start:.1f} s [{card}]")

    def launches(mod, *keys):
        return sum(c[mod].get(key, 0) for c in (c4, c5, c6, c7, c8, c9, c10, c11, c12, c13, c14,
                                                c15) if mod in c for key in keys)

    def entry(name, source, replaces, mod, key, main_config="float32"):
        mine = [r for r in rows if r["kernel"] == name]
        main_row = next(r for r in mine if r["config"] == main_config)
        keys = (key, "split_finish") if name == "fused_mlp" else (key,)  # a split block: one
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches(mod, *keys),
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
              "haconvdr_tpu/ops/fused_mlp.py:56", "fused_mlp", "kernel",
              f"bf16, {MLP_ROWS[-1]} rows"),
        # rows 11-12 at phase 9's bf16 shape: the tensor-core kernels
        entry("flash_attention_fwd", "haconvdr_torch/csrc/attention_tc.cuh",
              "haconvdr_tpu/ops/flash_attention.py:105", "flash_attention", "fwd",
              FLASH_MAIN),
        entry("flash_attention_bwd", "haconvdr_torch/csrc/attention_tc_bwd.cuh",
              "haconvdr_tpu/ops/flash_attention.py:174", "flash_attention", "bwd",
              FLASH_MAIN),
        # row 7 lies on no path of either package: phase 3 checks it alone
        entry("topk_stream", "haconvdr_torch/csrc/topk_stream.cu",
              "haconvdr_tpu/ops/pallas_topk_v2.py:38", "topk_stream", "kernel"),
        moe_entry(c16, rows16),
        dense_entry(launches("int8_dense", "dense") + c17["int8_dense"]["dense"], rows17),
    ]}))
    return finish(t_start, card)


def moe_entry(counts: dict, rows: list) -> dict:
    """Row 13 of the kernels line: phase 16's launches, its largest row
    error, and its times at the cell's skewed routing."""
    main_row = next(r for r in rows if r["config"] == "bf16, skewed")
    return {"name": "moe_experts", "route": "cuda", "source": "haconvdr_torch/csrc/moe_experts.cu",
            "replaces": None, "launches": counts["moe"]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def finish(t_start: float, card: str) -> int:
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all, the build included [{card}]")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
