"""Streaming exact inner-product top-k over one passage block (counterpart
of haconvdr_tpu/ops/pallas_topk_v2.py:pallas_topk_block_v2).

``topk_block_v2`` launches the CUDA kernel (csrc/topk_stream.cu: the split
pass of the v3 kernel, csrc/topk_split.cuh, run unseeded, then a merge of
the splits) for CUDA tensors and runs the plain twin
``topk_block_v2_plain`` for CPU tensors; there is no other route.  No path
of either package calls it: the JAX package runs its kernel only in tests.

Contract of both, as the JAX function's:

* queries [Q, D], passages [N, D] float32 or bfloat16 with N a multiple of
  ``p_chunk * group`` (``p_chunk`` 0 means 2048 for bfloat16 passages and
  1024 otherwise), else ValueError;
* scores are ``q . p`` accumulated in float32 over rows < ``n_valid``;
  bfloat16 passages score bfloat16-rounded queries (the products are exact
  in float32);
* float32 scores [Q, k] and int32 row ids [Q, k], ordered (score desc, id
  asc); empty slots (k past the valid rows) are (-inf, -1);
* ``q_tile`` only sets the JAX kernel's query tile; the CUDA kernel tiles
  by 64 or 128 queries (:func:`stream_plan`) whatever it is.

k is at most ``MAX_K`` = 1024 (STREAM_KMAX of csrc/topk_stream.cu; the
JAX kernel takes any k): both functions raise ValueError above it.  The
kernel is the unseeded v3 kernel's split pass on the v3 kernel's unseeded
grid at every k (:func:`stream_plan`).  Up to k = 128 its per-query
buffers are in shared memory and its answer equals the v3 kernel's bit for
bit; above, each block keeps its buffers in device memory (two a query,
cand and a spare array of the same shape).
"""

from __future__ import annotations

from typing import Tuple

import torch

from haconvdr_torch.ops import _build
from haconvdr_torch.ops.fused_topk import MAX_K as MERGE_MAX_K
from haconvdr_torch.ops.fused_topk import (
    MAX_WAVES_UNSEEDED,
    _PLAIN_CHUNK,
    _finish,
    query_dtype,
    scan_topk_keys,
    split_geometry,
)

# launches of the CUDA kernel (split + merge count once) / plain-twin calls
COUNTS = {"kernel": 0, "plain": 0}
MAX_K = 1024  # STREAM_KMAX of csrc/topk_stream.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def resolve_p_chunk(p_chunk: int, dtype: torch.dtype) -> int:
    """The JAX function's default chunk: 2048 rows for bfloat16, else 1024."""
    if p_chunk:
        return p_chunk
    return 2048 if dtype == torch.bfloat16 else 1024


def _check(queries, passages, k, q_tile, p_chunk, group):
    if queries.dim() != 2 or passages.dim() != 2:
        raise ValueError("queries [Q, D] and passages [N, D] must be 2-d")
    if queries.shape[1] != passages.shape[1]:
        raise ValueError(
            f"dim mismatch: queries {tuple(queries.shape)}, passages {tuple(passages.shape)}"
        )
    if passages.dtype not in _DTYPE_CODE:
        raise ValueError(f"streaming top-k takes float32/bfloat16 passages, got {passages.dtype}")
    if not 0 < k <= MAX_K:
        raise ValueError(
            f"streaming top-k takes 0 < k <= {MAX_K} (STREAM_KMAX of csrc/topk_stream.cu), "
            f"got {k}"
        )
    if q_tile <= 0 or p_chunk <= 0 or group <= 0:
        raise ValueError(f"q_tile, p_chunk and group must be > 0, got {q_tile, p_chunk, group}")
    N = passages.shape[0]
    if N % (p_chunk * group):
        raise ValueError(
            f"passage rows ({N}) must be a multiple of p_chunk * group "
            f"({p_chunk} * {group}): pad the passages"
        )
    if N >= 2**31:
        raise ValueError("passage rows exceed int32 ids")


def topk_block_v2_plain(
    queries: torch.Tensor,
    passages: torch.Tensor,
    n_valid: int,
    k: int,
    q_tile: int = 256,
    p_chunk: int = 0,
    group: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch (see the module docstring)."""
    p_chunk = resolve_p_chunk(p_chunk, passages.dtype)
    _check(queries, passages, k, q_tile, p_chunk, group)
    COUNTS["plain"] += 1
    return _finish(scan_topk_keys(queries, passages, n_valid, k, _PLAIN_CHUNK))


def stream_plan(
    Q: int, k: int, rows: int, sms: int, dtype: torch.dtype, lib
) -> Tuple[int, int, int, bool]:
    """The kernel's launch for Q queries, k and ``rows`` rows over ``sms``
    SMs: (queries a block, splits, rows a split, whether the per-query
    buffers live in device memory).

    * Queries a block: up to k 128 the v3 kernel's split pass's, asked of
      ``lib`` (``hc_topk_split_qb``: 128 past Q 64 where a block's shared
      memory holds their buffers, else 64); past k 128, where the buffers
      are in device memory (cand and a spare array), 128 past Q 64, else
      64, and ``lib`` is not asked.
    * The grid: the v3 kernel's unseeded grid (``split_geometry`` at
      MAX_WAVES_UNSEEDED) at every k, rows a split a multiple of 128.
      Fewer, longer splits past k 128 (16 k rows each at least) measured
      slower at Q 1, 64 and 256 (probes/probe_torch_stream.py
      --geometries)."""
    wide = k > MERGE_MAX_K
    qb = (128 if Q > 64 else 64) if wide else lib.hc_topk_split_qb(Q, k, _DTYPE_CODE[dtype])
    splits, per = split_geometry(Q, rows, sms, qb, MAX_WAVES_UNSEEDED)
    return qb, splits, per, wide


def topk_block_v2(
    queries: torch.Tensor,  # [Q, D]
    passages: torch.Tensor,  # [N, D], N % (p_chunk * group) == 0
    n_valid: int,
    k: int,
    q_tile: int = 256,
    p_chunk: int = 0,
    group: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (scores [Q, k] float32, ids [Q, k] int32) top-k of one block,
    ordered (score desc, id asc); see the module docstring."""
    if passages.device.type == "cpu":
        return topk_block_v2_plain(queries, passages, n_valid, k, q_tile, p_chunk, group)
    if passages.device.type != "cuda":
        raise ValueError(f"unsupported device {passages.device}")
    p_chunk = resolve_p_chunk(p_chunk, passages.dtype)
    _check(queries, passages, k, q_tile, p_chunk, group)
    if queries.device != passages.device:
        raise ValueError("queries and passages must be on one device")
    if not passages.is_contiguous():
        raise ValueError("passages must be contiguous")
    D = passages.shape[1]
    lib = _build.library()
    dev = passages.device
    q = queries.to(query_dtype(passages.dtype)).contiguous()
    Q, N = q.shape[0], passages.shape[0]
    rows = max(0, min(int(n_valid), N))
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    code = _DTYPE_CODE[passages.dtype]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qb, splits, per, wide = stream_plan(Q, k, rows, sms, passages.dtype, lib)
    cand = torch.empty((splits, Q, k), dtype=torch.int64, device=dev)
    spare = torch.empty_like(cand) if wide else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_topk_stream(
            q.data_ptr(), passages.data_ptr(), Q, N, D, rows, k, qb, per, splits,
            cand.data_ptr(), None if spare is None else spare.data_ptr(), code, stream,
        )
        _build.check(err, "hc_topk_stream")
        if not wide:
            err = lib.hc_topk_merge(
                cand.data_ptr(), splits, Q, k, None, 0, out_s.data_ptr(), out_i.data_ptr(),
                stream,
            )
        else:
            err = lib.hc_topk_stream_merge(
                cand.data_ptr(), splits, Q, k, out_s.data_ptr(), out_i.data_ptr(), stream,
            )
        _build.check(err, "hc_topk_merge")
    COUNTS["kernel"] += 1
    return out_s, out_i
