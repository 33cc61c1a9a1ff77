"""Fused exact inner-product top-k over one resident passage block
(counterpart of haconvdr_tpu/ops/pallas_topk.py:pallas_topk_block).

``fused_topk_block`` launches the CUDA kernels (csrc/fused_topk.cu) for
CUDA tensors and runs the plain twin ``fused_topk_block_plain`` for CPU
tensors; there is no other route.  Contract of both:

* scores are ``q . p`` accumulated in float32; bfloat16 and int8
  passages score bfloat16-rounded queries (the products are exact in
  float32).  int8 is the int8 index's mode (pallas_topk.py:126-131,
  203-207): the per-dim scale is folded into float queries by the caller,
  or the queries are int8 codes already (v4's fallback), which bfloat16
  holds exactly;
* rows at or past ``n_valid`` never surface;
* ``init_scores`` [Q, ks] seeds the search with a running best: its k-th
  largest value per query (its row minimum when ks == k) is a strict
  threshold, and seed values that stay in the top k come back with id -1;
* empty slots are (-inf, -1);
* results are ordered (score desc, id asc): ties go to the lower id;
* ``presample`` (unseeded only, off by default) seeds the kernel with a
  threshold from a sample of the rows (pallas_topk.py:235-279, see
  :func:`presample_threshold`); the answers are the unseeded ones.

The order is carried by one int64 key per entry (order-preserving score
bits in the high word, ``0x7fffffff - id`` in the low word), so selection
is a top-k over distinct integers and never depends on how
``torch.topk`` breaks ties.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from haconvdr_torch.ops import _build

# launches of the CUDA kernels (split + merge count once) / plain-twin calls
COUNTS = {"kernel": 0, "plain": 0}
MAX_K = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ID_BASE = 0x7FFFFFFF
TILE_ROWS = 128  # passage rows of the split kernel's tile
MAX_SPLITS = 65535
_PLAIN_CHUNK = 65536  # rows per [Q, chunk] score tile of the plain twin


def query_dtype(passage_dtype: torch.dtype) -> torch.dtype:
    """The dtype queries are rounded to before scoring ``passage_dtype``
    rows: the passages' own float dtype, bfloat16 for int8 passages."""
    return torch.bfloat16 if passage_dtype == torch.int8 else passage_dtype


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


PRESAMPLE_TILE = 1024  # rows of a sampling tile (the TPU kernel's p_tile)
PRESAMPLE_AUTO = 16  # sample rows a tile under presample < 0
PRESAMPLE_MIN_ROWS = 1 << 18  # below this many rows the auto presample is off
PRESAMPLE_MARGIN = 1e-5


def presample_threshold(
    queries: torch.Tensor, passages: torch.Tensor, n_valid: int, k: int, presample: int
) -> Optional[torch.Tensor]:
    """[Q] seed threshold of the presample pre-pass, or None when it is off
    (haconvdr_tpu/ops/pallas_topk.py:235-279): the first ``presample`` rows
    of every ``PRESAMPLE_TILE``-row tile (16 under ``presample < 0``,
    which is off below 2**18 rows), scored in one ``torch.matmul`` in the
    kernel's scoring model, rows at or past ``n_valid`` left out; each
    query's k-th sample score less ``(|vk| + 1) * 1e-5``, -inf where there
    is none.  Off too when the sample holds fewer than k rows.  The sample
    rows are rows of the block, so at least k rows score at or above vk,
    above the threshold: it prunes nothing of the answer."""
    if presample == 0:
        return None
    N = passages.shape[0]
    nt = -(-N // PRESAMPLE_TILE)
    spp = min(PRESAMPLE_AUTO if presample < 0 else presample, PRESAMPLE_TILE)
    if (presample < 0 and nt * PRESAMPLE_TILE < PRESAMPLE_MIN_ROWS) or nt * spp < k:
        return None
    dev = passages.device
    limit = min(int(n_valid), N)
    if (limit // PRESAMPLE_TILE) * spp + min(spp, limit % PRESAMPLE_TILE) < k:
        return torch.full((queries.shape[0],), float("-inf"), device=dev)
    # rows past the limit are scored and masked, not filtered out: a
    # boolean index would wait on the host for the card
    rows = (torch.arange(nt, device=dev)[:, None] * PRESAMPLE_TILE
            + torch.arange(spp, device=dev)[None, :]).reshape(-1)
    qf = queries.to(query_dtype(passages.dtype)).to(torch.float32)
    s = qf @ passages[rows.clamp_max(N - 1)].to(torch.float32).T  # [Q, S]
    s = torch.where(rows[None, :] < limit, s, float("-inf"))
    vk = torch.topk(s, k, dim=1).values[:, k - 1]
    t = vk - (vk.abs() + 1.0) * PRESAMPLE_MARGIN
    return torch.where(torch.isfinite(vk), t, float("-inf")).contiguous()


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
    qf = queries.to(query_dtype(passages.dtype)).to(torch.float32)
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
    presample: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch (see the module docstring):
    float32 scores [Q, k], int32 ids [Q, k]."""
    COUNTS["plain"] += 1
    if init_scores is not None:
        thr = seed_threshold(init_scores, k)
    else:
        thr = presample_threshold(queries, passages, n_valid, k, presample)
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

# waves the split kernel's grid may take to fill its SMs: an unseeded
# block's first tile passes every score (~7% of a block at Q 256), so
# unseeded grids take fewer, longer blocks; seeded blocks pay nothing of
# the kind and take whole waves (probes/probe_torch_v3.py --geometries)
MAX_WAVES_UNSEEDED = 2
MAX_WAVES_SEEDED = 8


@functools.lru_cache(maxsize=256)
def split_geometry(Q: int, rows: int, sms: int, qb: int,
                   max_waves: int = MAX_WAVES_UNSEEDED) -> Tuple[int, int]:
    """(splits, rows per split) of the split kernel's grid: ceil(Q / qb)
    query tiles x splits blocks at one block an SM.  Of the split counts
    whose grid takes at most ``max_waves`` waves over ``sms`` SMs (one
    split where a single split's grid takes more), the one that fills its
    waves the most, the fewest of those: whole waves wherever the query
    tiles allow it (at two waves, Q 1 to 512 and 1,024 at 128 queries a
    tile over 132 SMs), else the fullest fill below (two waves, Q 513-640:
    26 splits, one wave on 130 of 132 SMs), never more splits than the
    rows hold 128-row tiles.  Rows per split are a multiple of TILE_ROWS
    and the splits cover ``rows`` (the last ones may be short or empty),
    so every block but the last splits' takes the same number of tiles.
    0 rows or 0 queries: one split of one tile."""
    tiles = -(-max(rows, 0) // TILE_ROWS)
    if Q <= 0 or tiles == 0:
        return 1, TILE_ROWS
    n_qt = -(-Q // qb)

    def fill(s: int) -> float:
        blocks = s * n_qt
        return blocks / (-(-blocks // sms) * sms)

    top = min(tiles, MAX_SPLITS, max(1, max_waves * sms // n_qt))
    splits = max(range(1, top + 1), key=lambda s: (fill(s), -s))
    return splits, -(-tiles // splits) * TILE_ROWS


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
            f"fused top-k kernel takes float32/bfloat16/int8 passages, got "
            f"{passages.dtype}"
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
    presample: int = 0,  # sample rows a tile; < 0 auto; 0 off
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (scores [Q, k] float32, ids [Q, k] int32) top-k of one block,
    ordered (score desc, id asc); see the module docstring.  A presample
    threshold seeds the kernel as a threshold only, never as buffer
    entries, so it surfaces no seed entry."""
    if passages.device.type == "cpu":
        return fused_topk_block_plain(queries, passages, n_valid, k, init_scores, presample)
    if passages.device.type != "cuda":
        raise ValueError(f"unsupported device {passages.device}")
    _check(queries, passages, k, init_scores)
    lib = _build.library()
    dev = passages.device
    q = queries.to(query_dtype(passages.dtype)).contiguous()
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
    elif presample:
        thr = presample_threshold(q, passages, rows, k, presample)
    qb = lib.hc_topk_split_qb(Q, k, _DTYPE_CODE[passages.dtype])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = MAX_WAVES_UNSEEDED if thr is None else MAX_WAVES_SEEDED
    splits, per = split_geometry(Q, rows, sms, qb, waves)
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
