"""Fused exact inner-product top-k over one resident passage block
(counterpart of haconvdr_tpu/ops/pallas_topk.py:pallas_topk_block).

``fused_topk_block`` launches the CUDA kernels (csrc/fused_topk.cu) for
CUDA tensors and runs the plain twin ``fused_topk_block_plain`` for CPU
tensors; there is no other route.  Contract of both:

* scores are ``q . p`` accumulated in float32; bfloat16 passages score
  bfloat16-rounded queries (the products are exact in float32);
* rows at or past ``n_valid`` never surface;
* ``init_scores`` [Q, ks] seeds the search with a running best: its k-th
  largest value per query (its row minimum when ks == k) is a strict
  threshold, and seed values that stay in the top k come back with id -1;
* empty slots are (-inf, -1);
* results are ordered (score desc, id asc): ties go to the lower id.

The order is carried by one int64 key per entry (order-preserving score
bits in the high word, ``0x7fffffff - id`` in the low word), so selection
is a top-k over distinct integers and never depends on how
``torch.topk`` breaks ties.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from haconvdr_torch.ops import _build

# launches of the CUDA kernels (split + merge count once) / plain-twin calls
COUNTS = {"kernel": 0, "plain": 0}
MAX_K = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ID_BASE = 0x7FFFFFFF
_MIN_SPLIT_ROWS = 2048
_PLAIN_CHUNK = 65536  # rows per [Q, chunk] score tile of the plain twin


# ---------------------------------------------------------------------------
# ordering keys
# ---------------------------------------------------------------------------

def order_keys(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (score desc, id asc): a larger key is a
    better entry.  ``scores`` float32; ``ids`` integers in [-1, 2**31),
    broadcastable to ``scores``.  -0.0 is folded onto +0.0."""
    b = (scores.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    hi = torch.where(b >= 0, b, -1 - b - 2**31)  # signed, order-preserving
    return hi * 2**32 + (_ID_BASE - ids.to(torch.int64))


def decode_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`order_keys`: (float32 scores, int32 ids)."""
    hi = torch.div(keys, 2**32, rounding_mode="floor")
    low = keys - hi * 2**32
    b = torch.where(hi >= 0, hi, -1 - hi - 2**31)
    return b.to(torch.int32).view(torch.float32), (_ID_BASE - low).to(torch.int32)


def empty_keys(rows: int, k: int, device) -> torch.Tensor:
    """[rows, k] keys of the empty entry (-inf, -1)."""
    return order_keys(
        torch.full((rows, k), float("-inf"), device=device),
        torch.full((1, 1), -1, dtype=torch.int64, device=device),
    )


def top_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest keys of each row, descending (keys are distinct up to
    identical entries, so the result does not depend on tie handling)."""
    return torch.topk(keys, min(k, keys.shape[1]), dim=1).values


def seed_threshold(init_scores: torch.Tensor, k: int) -> torch.Tensor:
    """Per-query strict threshold of a seed [Q, ks]: its k-th largest value
    (the row minimum when ks == k).  A row scoring at or below it cannot
    enter the top k, since k seed entries beat or tie it and the seed wins
    ties.  A seed narrower than k bounds nothing (-inf)."""
    s = init_scores.to(torch.float32)
    if s.shape[1] < k:
        return torch.full(s.shape[:1], float("-inf"), device=s.device)
    return torch.topk(s, k, dim=1).values[:, -1].contiguous()


def scan_topk_keys(
    queries: torch.Tensor,
    passages: torch.Tensor,
    n_valid: int,
    k: int,
    chunk: int = 65536,
    threshold: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain chunked scan: [Q, k] top keys (ids = row offsets) over rows
    [0, n_valid), one [Q, chunk] float32 score tile live at a time.  Rows
    scoring at or below ``threshold`` ([Q]) are left out.  Short results
    are padded with empty keys."""
    Q = queries.shape[0]
    dev = queries.device
    qf = queries.to(passages.dtype).to(torch.float32)
    best = empty_keys(Q, k, dev)
    for c0 in range(0, min(int(n_valid), passages.shape[0]), chunk):
        c1 = min(int(n_valid), passages.shape[0], c0 + chunk)
        s = qf @ passages[c0:c1].to(torch.float32).T
        if threshold is not None:
            s = s.masked_fill(s <= threshold[:, None], float("-inf"))
        keys = order_keys(s, torch.arange(c0, c1, device=dev)[None, :])
        best = top_keys(torch.cat([best, top_keys(keys, k)], dim=1), k)
    return best


def _finish(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoded (scores, ids); anything scoring -inf is an empty slot."""
    s, i = decode_keys(keys)
    return s, torch.where(torch.isneginf(s), torch.full_like(i, -1), i)


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def fused_topk_block_plain(
    queries: torch.Tensor,
    passages: torch.Tensor,
    n_valid: int,
    k: int,
    init_scores: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch (see the module docstring):
    float32 scores [Q, k], int32 ids [Q, k]."""
    COUNTS["plain"] += 1
    thr = None if init_scores is None else seed_threshold(init_scores, k)
    keys = scan_topk_keys(queries, passages, n_valid, k, _PLAIN_CHUNK, thr)
    if init_scores is not None:
        seed = order_keys(
            init_scores.to(device=keys.device, dtype=torch.float32),
            torch.full((1, 1), -1, dtype=torch.int64, device=keys.device),
        )
        keys = top_keys(torch.cat([seed, keys], dim=1), k)
    return _finish(keys)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _n_splits(dev: torch.device, n_qtiles: int, rows: int) -> Tuple[int, int]:
    """(splits, rows per split): about two resident blocks per SM over the
    grid, each split at least _MIN_SPLIT_ROWS rows, rows a multiple of 64."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, -(-2 * sms // n_qtiles))
    by_rows = max(1, rows // _MIN_SPLIT_ROWS)
    splits = max(1, min(want, by_rows, 65535))
    per = -(-max(rows, 1) // splits)
    per = -(-per // 64) * 64
    return -(-max(rows, 1) // per), per


def _check(queries, passages, k, init_scores):
    if queries.dim() != 2 or passages.dim() != 2:
        raise ValueError("queries [Q, D] and passages [N, D] must be 2-d")
    if queries.shape[1] != passages.shape[1]:
        raise ValueError(
            f"dim mismatch: queries {tuple(queries.shape)}, "
            f"passages {tuple(passages.shape)}"
        )
    if passages.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"fused top-k kernel takes float32/bfloat16 passages, got "
            f"{passages.dtype} (int8 waits for the index/quantize.py port)"
        )
    if not 0 < k <= MAX_K:
        raise ValueError(f"fused top-k kernel takes 0 < k <= {MAX_K}, got {k}")
    if passages.shape[0] >= 2**31:
        raise ValueError("passage rows exceed int32 ids")
    if queries.device != passages.device:
        raise ValueError("queries and passages must be on one device")
    if not passages.is_contiguous():
        raise ValueError("passages must be contiguous")
    if init_scores is not None and (
        init_scores.dim() != 2 or init_scores.shape[0] != queries.shape[0]
    ):
        raise ValueError(
            f"init_scores must be [{queries.shape[0]}, ks], got "
            f"{tuple(init_scores.shape)}"
        )


def fused_topk_block(
    queries: torch.Tensor,  # [Q, D]
    passages: torch.Tensor,  # [N, D]
    n_valid: int,
    k: int,
    init_scores: Optional[torch.Tensor] = None,  # [Q, ks] running best
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (scores [Q, k] float32, ids [Q, k] int32) top-k of one block,
    ordered (score desc, id asc); see the module docstring."""
    if passages.device.type == "cpu":
        return fused_topk_block_plain(queries, passages, n_valid, k, init_scores)
    if passages.device.type != "cuda":
        raise ValueError(f"unsupported device {passages.device}")
    _check(queries, passages, k, init_scores)
    lib = _build.library()
    dev = passages.device
    q = queries.to(passages.dtype).contiguous()
    Q, D = q.shape
    N = passages.shape[0]
    rows = max(0, min(int(n_valid), N))
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    seed = thr = None
    if init_scores is not None:
        seed = init_scores.to(device=dev, dtype=torch.float32).contiguous()
        thr = seed_threshold(seed, k)
    splits, per = _n_splits(dev, -(-Q // 64), rows)
    cand = torch.empty((splits, Q, k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hc_topk_split(
            q.data_ptr(), passages.data_ptr(), Q, N, D, rows, k,
            None if thr is None else thr.data_ptr(), per, splits,
            cand.data_ptr(), _DTYPE_CODE[passages.dtype], stream,
        )
        _build.check(err, "hc_topk_split")
        err = lib.hc_topk_merge(
            cand.data_ptr(), splits, Q, k,
            None if seed is None else seed.data_ptr(),
            0 if seed is None else seed.shape[1],
            out_s.data_ptr(), out_i.data_ptr(), stream,
        )
        _build.check(err, "hc_topk_merge")
    COUNTS["kernel"] += 1
    return out_s, out_i
