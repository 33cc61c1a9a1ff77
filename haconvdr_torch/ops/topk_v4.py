"""The v4 window-top-2 exact top-k (counterpart of
haconvdr_tpu/ops/pallas_topk_v4.py): three CUDA kernels (csrc/topk_v4.cu)
and the glue between them, with a counted fallback to the v3 kernel.

``topk_block_v4`` is the counterpart of ``pallas_topk_block_v4``:

1. int8 passages: the float queries are quantized per query
   (index/quantize.py ``quantize_queries_int8``), and every score below is
   an exact integer of int8 x int8 products;
2. ``v4_search``: ``window_top2`` reduces every ``sw``-row window to (max,
   its lowest row, second max) as [W, Q] panels, on the route
   ``window_route`` picks for the batch (streaming for small Q, tiled
   products for large; every route gives the same bits); ``select_topk_t`` finds
   v_k, the k-th largest window max (a lower bound of the k-th score);
   windows whose second max reaches v_k are flagged and, up to ``budget``
   per query, rescored row by row by ``rescore_windows``; ``select_topk``
   takes the top k of [unflagged window maxima | rescored rows];
3. if some query flagged more than ``budget`` windows, the v4 answer may
   miss a row, and the whole batch runs the v3 kernel
   (ops/fused_topk.py) on the same queries instead, counted in
   ``COUNTS["v3_fallback"]``.  Deciding this reads ``n_flag`` on the host:
   one device sync per search;
4. int8: scores dequantize once, after that choice, as
   ``s * (q_scale / 127)``.

The two selects are one kernel: each query's panel column (or row) is
cut into ``select_splits`` runs, one block each, whose exact top k a
second launch merges; a run is read once, 512 entries a step, against a
running top k (csrc/topk_v4.cu, section 3).

Results are ordered (score desc, passage id asc) like the v3 kernel's, so
the two paths return the same answer: the final selection breaks ties by
passage id, not by position in the pool.  Each kernel wrapper launches
its kernel for CUDA tensors and runs its plain twin (``*_plain``) for CPU
tensors; there is no other route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from haconvdr_torch.index.quantize import quantize_queries_int8
from haconvdr_torch.ops import _build
from haconvdr_torch.ops.fused_topk import MAX_K, decode_keys, fused_topk_block, order_keys

# kernel launches by wrapper ("window" all of the window kernel's, "window_a"
# .. "window_c" by route); "plain" counts plain-twin calls of any of them
COUNTS = {"window": 0, "window_a": 0, "window_b": 0, "window_c": 0, "select_t": 0,
          "select": 0, "rescore": 0, "v3_fallback": 0, "plain": 0}
NEG_INF = float("-inf")
_MODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_TILE_ROWS = 64  # the window kernel's slices and tile halves: sw must be a multiple
_ROUTE_CODE = {"a": 0, "b": 1, "c": 2}
_ROUTE_DTYPES = {"a": tuple(_MODE), "b": (torch.float32, torch.bfloat16), "c": (torch.int8,)}
# route A holds a group of up to 16 queries in shared memory (floats, or
# int8): past this many bytes of them a batch takes the route of larger Q
_STREAM_QUERY_BYTES = 98_304
# the largest Q that takes route A (see window_route)
_STREAM_MAX_Q = {torch.float32: 16, torch.bfloat16: 32, torch.int8: 8}
_PLAIN_ROWS = 65536  # rows per score tile of the plain twins
_NO_KEY = torch.iinfo(torch.int64).min  # below every real key
SEL_ROWS = 512  # entries of a query a select block stages per step (csrc/topk_v4.cu)


def resolve_select_geometry(
    n_rows: int, index_dtype: torch.dtype, seg_width: int = 0, budget: int = 0
) -> Tuple[int, int]:
    """(seg_width, budget) of a v4 search; 0 means auto, as in
    pallas_topk_v4.py:64-95 without its N % 2048 condition (nothing is
    padded here): sw 256 from 2M rows, else 128; budget 8 (float) or 6
    (int8) at sw >= 256, 4 below."""
    if seg_width == 0:
        seg_width = 256 if n_rows >= 2_000_000 else 128
    if budget == 0:
        if seg_width >= 256:
            budget = 6 if index_dtype == torch.int8 else 8
        else:
            budget = 4
    return seg_width, budget


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# kernel 1: window top-2
# ---------------------------------------------------------------------------

def window_top2_plain(
    queries: torch.Tensor, passages: torch.Tensor, n_valid: int, sw: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`window_top2`."""
    COUNTS["plain"] += 1
    Q = queries.shape[0]
    N = passages.shape[0]
    W = -(-N // sw)
    rows = max(0, min(int(n_valid), N))
    dev = queries.device
    qf = queries.to(torch.float32)
    v1 = torch.empty((W, Q), dtype=torch.float32, device=dev)
    a1 = torch.empty((W, Q), dtype=torch.int32, device=dev)
    v2 = torch.empty((W, Q), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_ROWS // sw)  # windows per score tile
    lane = torch.arange(sw, device=dev)
    for w0 in range(0, W, step):
        w1 = min(W, w0 + step)
        r0, r1 = w0 * sw, w1 * sw
        s = qf @ passages[r0:min(r1, N)].to(torch.float32).T
        s = F.pad(s, (0, r1 - r0 - s.shape[1]), value=NEG_INF)
        s = s.masked_fill(torch.arange(r0, r1, device=dev)[None, :] >= rows, NEG_INF)
        seg = s.view(Q, w1 - w0, sw)
        top = seg.amax(dim=2)
        # the lowest row holding the max (all -inf: the window's first row)
        pos = torch.where(seg == top[..., None], lane, sw).amin(dim=2)
        second = seg.scatter(2, pos[..., None], NEG_INF).amax(dim=2)
        v1[w0:w1] = top.T
        a1[w0:w1] = (pos + (torch.arange(w0, w1, device=dev) * sw)[None, :]).T.to(torch.int32)
        v2[w0:w1] = second.T
    return v1, a1, v2


def _check_pair(queries, passages):
    if queries.dim() != 2 or passages.dim() != 2 or queries.shape[1] != passages.shape[1]:
        raise ValueError(
            f"queries [Q, D] and passages [N, D] expected, got "
            f"{tuple(queries.shape)} and {tuple(passages.shape)}"
        )
    if passages.dtype not in _MODE or queries.dtype != passages.dtype:
        raise ValueError(
            f"v4 kernels take float32, bfloat16 or int8 queries and passages of "
            f"one dtype, got {queries.dtype} x {passages.dtype}"
        )
    if queries.device != passages.device:
        raise ValueError("queries and passages must be on one device")
    if not (queries.is_contiguous() and passages.is_contiguous()):
        raise ValueError("queries and passages must be contiguous")
    if passages.shape[0] >= 2**31:
        raise ValueError("passage rows exceed int32 ids")
    if passages.dtype == torch.int8 and (
        passages.shape[1] % 4 or queries.data_ptr() % 4 or passages.data_ptr() % 4
    ):
        raise ValueError("int8 x int8 kernels read 4-byte words: D % 4 == 0, aligned rows")


def _stream_query_bytes(Q: int, dtype: torch.dtype, D: int) -> int:
    """Shared memory that route A's group of queries takes: the group (1,
    4, 8 or 16 queries) times the chunks of a row, widened to float in the
    float modes (csrc/topk_v4.cu, Elem::Q_CHUNK)."""
    group = 1 if Q <= 1 else 4 if Q <= 4 else 8 if Q <= 8 else 16
    chunk = 128 if group <= 8 else 64  # bytes of a row a stage (Stream::CH)
    esz = torch.empty((), dtype=dtype).element_size()
    chunks = -(-D * esz // chunk)
    return group * chunks * chunk * (1 if dtype == torch.int8 else 4 // esz)


def window_route(Q: int, dtype: torch.dtype, D: int = 768) -> str:
    """The window kernel's route for Q queries of ``dtype`` and width D:
    "a" (streaming: every passage row read once, for small batches), else
    "b" (register-tiled fmaf, float32 and bfloat16) or "c" (int8 on the
    tensor cores).  Route A takes Q up to 16 (float32), 32 (bfloat16) or
    8 (int8), while its group of queries fits in shared memory.  The
    crossover, device ms over 2,500,000 x 768 rows (probes/
    probe_torch_window.py --routes; NVIDIA H100 80GB HBM3, 700 W), route A
    against the tiled route:

    ====  ===============  ===============  ===============
    Q     float32 (A / B)  bfloat16 (A / B)  int8 (A / C)
    ====  ===============  ===============  ===============
    1     2.60 / 7.05      1.29 / 7.51      0.636 / 0.821
    8     2.69 / 7.06      1.78 / 7.52      0.723 / 0.817
    16    4.37 / 7.01      2.94 / 7.48      0.942 / 0.809
    32    8.15 / 7.02      6.30 / 7.53      1.89 / 0.813
    64    16.8 / 7.09      12.5 / 7.57      3.84 / 0.813
    ====  ===============  ===============  ===============

    Past 16 queries route A runs groups of 16, each reading the rows again
    (from L2), while the tiled routes cost the same from 1 to 64 queries
    (one 64-query tile)."""
    if Q <= _STREAM_MAX_Q[dtype] and _stream_query_bytes(Q, dtype, D) <= _STREAM_QUERY_BYTES:
        return "a"
    return "c" if dtype == torch.int8 else "b"


def window_top2(
    queries: torch.Tensor,  # [Q, D], the passages' dtype
    passages: torch.Tensor,  # [N, D]
    n_valid: int,
    sw: int,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per ``sw``-row window and query: (v1 max [W, Q] float32, a1 its
    lowest row [W, Q] int32, v2 the max with only row a1 masked [W, Q]
    float32), W = ceil(N / sw).  Rows at or past ``n_valid`` score -inf;
    int8 x int8 scores are exact integers.  On the card the kernel runs
    ``route`` (tests and probes; default :func:`window_route`); every
    route gives the same bits."""
    if _device_kind(passages) == "cpu":
        return window_top2_plain(queries, passages, n_valid, sw)
    _check_pair(queries, passages)
    if sw <= 0 or sw % _TILE_ROWS:
        raise ValueError(f"window kernel takes sw a multiple of {_TILE_ROWS}, got {sw}")
    Q, D = queries.shape
    if route is None:
        route = window_route(Q, passages.dtype, D)
    if passages.dtype not in _ROUTE_DTYPES.get(route, ()):
        raise ValueError(f"window route {route!r} does not take {passages.dtype}: "
                         "a (any), b (float32, bfloat16), c (int8)")
    if route == "a" and _stream_query_bytes(Q, passages.dtype, D) > _STREAM_QUERY_BYTES:
        raise ValueError(f"window route a holds its queries in shared memory: D {D} is too wide")
    lib = _build.library()
    dev = passages.device
    N = passages.shape[0]
    W = max(1, -(-N // sw))
    v1 = torch.empty((W, Q), dtype=torch.float32, device=dev)
    a1 = torch.empty((W, Q), dtype=torch.int32, device=dev)
    v2 = torch.empty((W, Q), dtype=torch.float32, device=dev)
    if Q == 0:
        return v1, a1, v2
    with torch.cuda.device(dev):
        err = lib.hc_window_top2(
            queries.data_ptr(), passages.data_ptr(), Q, N, D, int(n_valid), sw, W,
            _ROUTE_CODE[route], v1.data_ptr(), a1.data_ptr(), v2.data_ptr(),
            _MODE[passages.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "hc_window_top2")
    COUNTS["window"] += 1
    COUNTS["window_" + route] += 1
    return v1, a1, v2


# ---------------------------------------------------------------------------
# kernel 2: flagged-window rescore
# ---------------------------------------------------------------------------

def _window_rows(win_ids: torch.Tensor, sw: int, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, B * sw] global rows of the slots' windows, and their validity
    (slot not empty, row < rows)."""
    r = win_ids.to(torch.int64)[:, :, None] * sw + torch.arange(sw, device=win_ids.device)
    valid = (win_ids[:, :, None] >= 0) & (r < rows)
    Q = win_ids.shape[0]
    return r.reshape(Q, -1), valid.reshape(Q, -1)


def rescore_windows_plain(
    passages: torch.Tensor, queries: torch.Tensor, win_ids: torch.Tensor, sw: int, n_valid: int
) -> torch.Tensor:
    """Plain twin of :func:`rescore_windows`."""
    COUNTS["plain"] += 1
    rows = max(0, min(int(n_valid), passages.shape[0]))
    r, valid = _window_rows(win_ids, sw, rows)
    gathered = passages[torch.where(valid, r, 0)].to(torch.float32)  # [Q, B*sw, D]
    s = (gathered @ queries.to(torch.float32)[:, :, None])[..., 0]
    return s.masked_fill(~valid, NEG_INF)


def rescore_windows(
    passages: torch.Tensor,  # [N, D]
    queries: torch.Tensor,  # [Q, D], the passages' dtype
    win_ids: torch.Tensor,  # [Q, B] int32 window ids; negative = empty slot
    sw: int,
    n_valid: int,
) -> torch.Tensor:
    """[Q, B * sw] float32: entry (q, b * sw + r) is query q's score of row
    win_ids[q, b] * sw + r, the same float the window kernel computes for
    that row; -inf for empty slots and rows at or past ``n_valid``."""
    if _device_kind(passages) == "cpu":
        return rescore_windows_plain(passages, queries, win_ids, sw, n_valid)
    _check_pair(queries, passages)
    if win_ids.dim() != 2 or win_ids.shape[0] != queries.shape[0]:
        raise ValueError(f"win_ids must be [{queries.shape[0]}, B], got {tuple(win_ids.shape)}")
    if win_ids.dtype != torch.int32 or not win_ids.is_contiguous() or win_ids.device != passages.device:
        raise ValueError("win_ids must be a contiguous int32 tensor on the passages' device")
    if sw <= 0:
        raise ValueError(f"sw must be positive, got {sw}")
    lib = _build.library()
    Q, B = win_ids.shape
    out = torch.empty((Q, B * sw), dtype=torch.float32, device=passages.device)
    if Q == 0 or B == 0:
        return out
    with torch.cuda.device(passages.device):
        err = lib.hc_rescore_windows(
            queries.data_ptr(), passages.data_ptr(), Q, passages.shape[0], passages.shape[1],
            int(n_valid), sw, B, win_ids.data_ptr(), out.data_ptr(),
            _MODE[passages.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "hc_rescore_windows")
    COUNTS["rescore"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 3: exact top-k over a score panel
# ---------------------------------------------------------------------------

def select_plain(
    scores: torch.Tensor,  # [Q, C] (any strides)
    k: int,
    floor: Optional[torch.Tensor] = None,
    ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the select kernel, on a [Q, C] view."""
    COUNTS["plain"] += 1
    s = scores.to(torch.float32)
    Q, C = s.shape
    idv = torch.arange(C, device=s.device)[None, :] if ids is None else ids
    thr = torch.full((Q,), NEG_INF, device=s.device) if floor is None else floor
    keys = order_keys(s, idv).masked_fill(~(s > thr[:, None]), _NO_KEY)
    top = torch.topk(keys, min(k, C), dim=1).values
    v, i = decode_keys(top)
    hit = top != _NO_KEY
    return torch.where(hit, v, NEG_INF), torch.where(hit, i, -1)


def select_splits(Q: int, C: int, sms: int, queries_fast: bool) -> int:
    """Blocks along each query of a select: about eight warps an SM over
    the grid (one warp a query and split; a block takes 8 queries when the
    queries are the panel's fast axis, else one, and an SM holds one
    8-warp block: the kernel's 173 registers a thread), each split at most
    two tiles of SEL_ROWS entries.  Measured on the H100
    (probes/probe_torch_select.py --splits): at Q 256 the warps' instruction rate
    bounds the kernel and more splits only add steps; at small Q shorter
    splits win over the merge of splits * k candidates."""
    per_block = 8 if queries_fast else 1
    wave = 8 * sms // (-(-max(Q, 1) // per_block) * per_block)
    return max(1, min(wave, -(-C // (2 * SEL_ROWS)), 65535))


def _select(scores, k, floor, ids, counter, splits=None):
    """Top-k of each row of a [Q, C] view: (values [Q, kk], ids [Q, kk]),
    kk = min(k, C), ordered (score desc, id asc); the id of entry c is
    ids[q, c], else c.  Only entries above ``floor`` (per query) enter;
    empty slots are (-inf, -1).  On the card the kernel runs ``splits``
    blocks along each query (default :func:`select_splits`) and merges
    their top k; one split is a single launch."""
    if _device_kind(scores) == "cpu":
        return select_plain(scores, k, floor, ids)
    Q, C = scores.shape
    kk = min(k, C)
    if scores.dtype != torch.float32:
        raise ValueError(f"select kernel takes float32 scores, got {scores.dtype}")
    if not 0 < kk <= MAX_K:
        raise ValueError(f"select kernel takes 0 < k <= {MAX_K}, got {k} over {C} entries")
    if ids is not None and (
        ids.dtype != torch.int32 or ids.shape != scores.shape or ids.device != scores.device
        or any(a != b for a, b, n in zip(ids.stride(), scores.stride(), scores.shape) if n > 1)
    ):
        raise ValueError("ids must be int32 with the scores' shape, strides and device")
    if floor is not None:
        floor = floor.to(device=scores.device, dtype=torch.float32).contiguous()
        if floor.shape != (Q,):
            raise ValueError(f"floor must be [{Q}], got {tuple(floor.shape)}")
    lib = _build.library()
    out_s = torch.empty((Q, kk), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((Q, kk), dtype=torch.int32, device=scores.device)
    if Q == 0:
        return out_s, out_i
    if splits is None:
        sms = torch.cuda.get_device_properties(scores.device).multi_processor_count
        splits = select_splits(Q, C, sms, scores.stride(0) < scores.stride(1))
    head = (scores.data_ptr(), None if ids is None else ids.data_ptr(),
            None if floor is None else floor.data_ptr(), Q, C, scores.stride(0),
            scores.stride(1), kk)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        if splits == 1:
            err = lib.hc_select_topk(*head, out_s.data_ptr(), out_i.data_ptr(), stream)
        else:
            cand_s = torch.empty((Q, splits * kk), dtype=torch.float32, device=scores.device)
            cand_i = torch.empty((Q, splits * kk), dtype=torch.int32, device=scores.device)
            err = lib.hc_select_topk_split(
                *head, splits, cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(),
                out_i.data_ptr(), stream,
            )
    _build.check(err, "hc_select_topk")
    COUNTS[counter] += 1
    return out_s, out_i


def select_topk_t(
    scores_t: torch.Tensor,  # [C, Q] float32
    k: int,
    floor: Optional[torch.Tensor] = None,  # [Q] warm floor, below the k-th value
    ids_t: Optional[torch.Tensor] = None,  # [C, Q] int32 tie-break ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k per column of [C, Q] scores (counterpart of
    ``pallas_select_topk_t``): (values [Q, kk], row indices [Q, kk]) —
    or ``ids_t`` entries in place of row indices — kk = min(k, C)."""
    return _select(scores_t.T, k, floor, None if ids_t is None else ids_t.T, "select_t")


def select_topk(
    scores: torch.Tensor,  # [Q, C] float32
    k: int,
    floor: Optional[torch.Tensor] = None,
    ids: Optional[torch.Tensor] = None,  # [Q, C] int32 tie-break ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k per row of [Q, C] scores (counterpart of
    ``pallas_select_topk``), the same kernel as :func:`select_topk_t`."""
    return _select(scores, k, floor, ids, "select")


def warm_floor(scores_t: torch.Tensor, k: int) -> Optional[torch.Tensor]:
    """Per-query admission floor for the selects (pallas_topk_v4.py:706):
    the k-th largest 128-row segment max of [C, Q] scores, one ulp down.
    Segment maxima are some of the column's values, so the floor lies below
    the k-th value and prunes nothing of the answer.  None (cold) when
    there are fewer than k segments."""
    C, Q = scores_t.shape
    segs = -(-C // 128)
    if k > segs:
        return None
    v = F.pad(scores_t.T, (0, segs * 128 - C), value=NEG_INF)  # [Q, segs * 128]
    smax = v.reshape(Q, segs, 128).amax(dim=2)
    kth = torch.topk(smax, k, dim=1).values[:, -1]
    return torch.nextafter(kth, torch.full_like(kth, NEG_INF))


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def v4_search(
    queries: torch.Tensor,  # [Q, D], the passages' dtype
    passages: torch.Tensor,  # [N, D] float32 / bfloat16 / int8
    n_valid: int,
    k: int,
    seg_width: int = 0,
    budget: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores [Q, k], ids [Q, k], n_flag) of the v4 search (counterpart of
    ``_v4_search`` given queries in the kernels' dtype).  The answer is
    exact when ``n_flag <= budget``.  int8 queries against int8 passages
    give the integer scores; :func:`topk_block_v4` quantizes float
    queries and dequantizes."""
    if queries.dtype != passages.dtype:
        raise ValueError(
            f"v4_search takes queries in the passages' dtype, got {queries.dtype} "
            f"x {passages.dtype} (topk_block_v4 converts float queries)"
        )
    N = passages.shape[0]
    sw, B = resolve_select_geometry(N, passages.dtype, seg_width, budget)
    queries = queries.contiguous()
    Q = queries.shape[0]
    dev = passages.device
    rows = max(0, min(int(n_valid), N))

    v1T, a1T, v2T = window_top2(queries, passages, n_valid, sw)  # [W, Q]
    W = v1T.shape[0]
    if W >= k:
        v_k = select_topk_t(v1T, k, floor=warm_floor(v1T, k))[0][:, k - 1]
    else:  # fewer windows than k: v_k bounds nothing
        v_k = torch.full((Q,), NEG_INF, device=dev)
    flagT = (v2T >= v_k[None, :]) & torch.isfinite(v2T)
    n_flag = flagT.sum(dim=0).max() if Q else torch.zeros((), dtype=torch.int64)

    fw_s, fw = select_topk_t(torch.where(flagT, v2T, NEG_INF), B)
    win_ids = torch.where(fw_s > NEG_INF, fw, -1).to(torch.int32)
    if win_ids.shape[1] < B:
        win_ids = F.pad(win_ids, (0, B - win_ids.shape[1]), value=-1)
    win_ids = win_ids.contiguous()
    resc = rescore_windows(passages, queries, win_ids, sw, n_valid)  # [Q, B * sw]
    r, valid = _window_rows(win_ids, sw, rows)
    ridx = torch.where(valid, r, -1).to(torch.int32)

    # unflagged windows give their max; flagged ones all their rows
    pool = torch.cat([torch.where(flagT, NEG_INF, v1T).T, resc], dim=1)
    pool_ids = torch.cat([a1T.T, ridx], dim=1)
    kf = min(k, pool.shape[1])
    top_s, top_i = select_topk(pool, kf, floor=warm_floor(pool.T, kf), ids=pool_ids)
    if kf < k:
        top_s = F.pad(top_s, (0, k - kf), value=NEG_INF)
        top_i = F.pad(top_i, (0, k - kf), value=-1)
    return top_s, top_i, n_flag


def topk_block_v4_launch(
    queries: torch.Tensor,  # [Q, D] float
    passages: torch.Tensor,  # [N, D] float32 / bfloat16 / int8
    n_valid: int,
    k: int,
    seg_width: int = 0,
    budget: int = 0,
) -> tuple:
    """The v4 search's device work, queued without a host sync: the state
    :func:`topk_block_v4_finish` reads.  A caller searching several shards
    launches every shard's search before it finishes any, so no shard
    waits on another's ``n_flag``."""
    if not 0 < k <= MAX_K:
        raise ValueError(f"v4 search takes 0 < k <= {MAX_K}, got {k}")
    sw, B = resolve_select_geometry(passages.shape[0], passages.dtype, seg_width, budget)
    q_scale = None
    if passages.dtype == torch.int8:
        queries, q_scale = quantize_queries_int8(queries)
    else:
        queries = queries.to(passages.dtype)
    s, i, n_flag = v4_search(queries, passages, n_valid, k, sw, B)
    return s, i, n_flag, B, queries, passages, n_valid, k, q_scale


def topk_block_v4_finish(state: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """The answer of a :func:`topk_block_v4_launch`: its one host sync reads
    ``n_flag`` and falls back to the v3 kernel past the budget."""
    s, i, n_flag, B, queries, passages, n_valid, k, q_scale = state
    if int(n_flag) > B:  # the one host sync of the search
        COUNTS["v3_fallback"] += 1
        s, i = fused_topk_block(queries, passages, n_valid, k)
    if q_scale is not None:
        s = s * (q_scale[:, None] / 127.0)
    return s, i


def topk_block_v4(
    queries: torch.Tensor,  # [Q, D] float
    passages: torch.Tensor,  # [N, D] float32 / bfloat16 / int8
    n_valid: int,
    k: int,
    seg_width: int = 0,
    budget: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (scores [Q, k] float32, ids [Q, k] int32), ordered (score
    desc, id asc): the v4 search, or the v3 kernel when a query flagged
    more windows than the budget (counterpart of ``pallas_topk_block_v4``;
    see the module docstring)."""
    return topk_block_v4_finish(
        topk_block_v4_launch(queries, passages, n_valid, k, seg_width, budget)
    )
