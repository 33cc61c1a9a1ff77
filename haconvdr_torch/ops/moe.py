"""The routed experts of a mixture-of-experts layer: DeepSeek-V2's
``DeepseekV2MoE`` (router softmax, greedy top-k, each expert's SwiGLU MLP,
the route-weighted sum), for the DeepSeek-V2 query tower.

``routed_experts(x, gate_weight, w13, w2, top_k, scale)`` computes, for
tokens ``x`` [T, H] (bfloat16)::

    p = softmax(x @ gate_weight^T in float32)        # [T, E]
    w, e = the top_k of p (greedy), w times ``scale``
    y[t] = sum_j w[t, j] * bf16(expert_{e[t, j]}(x[t]))   (float32)
    expert(x) = bf16(bf16(silu(bf16(x @ G^T))) * bf16(x @ U^T)) @ D^T

with each expert's weights stacked: ``w13`` [E, 2I, H] (its I gate rows,
then its I up rows) and ``w2`` [E, H, I].  The shared experts are not here
(the tower runs them as a dense SwiGLU).

On CUDA tensors it launches csrc/moe_experts.cu: the routing kernel (one
warp a token: softmax, top-k, a slot of its expert), the grouped SwiGLU
up-projection over all experts in one launch, and the grouped
down-projection that scales by the route weight and adds into the token's
row (float32 atomics, so a row's last bit may vary run to run).  Every
grid is sized from T, k and E, so the forward reads nothing back.  On CPU
tensors, or with ``plain=True``, it runs the plain twin
``routed_experts_plain`` (a loop over the experts with ``F.linear``).

``COUNTS`` (read with every ``ops.*`` module's by
``utils.telemetry.read_counters``): ``forwards`` calls, ``tokens`` the
routed rows, ``assignments`` tokens x top_k, ``kernel`` and ``plain`` the
routes taken, ``launches`` the CUDA kernels launched (three a kernel call:
routing, up, down).  Two int64 accumulators on each device add up what the
router did, without a sync in the forward: the tokens each expert got
(``expert_loads``) and, summed over calls, the largest expert's count;
``device_counts`` reads the latter (``max_load_sum``) off the forward.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from haconvdr_torch.ops import _build
from haconvdr_torch.utils.telemetry import TRACER

COUNTS = {"forwards": 0, "tokens": 0, "assignments": 0, "kernel": 0, "launches": 0, "plain": 0}
ROWS_PER_TILE = 128  # rows of a product tile (csrc/moe_experts.cu: BM)
MAX_EXPERTS = 64  # csrc/moe_experts.cu: MAX_E
MAX_TOP_K = 16

# (device, experts) -> (loads int64 [E], sum of the largest load int64 [1])
_ACCUMULATORS: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _accumulators(device: torch.device, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device, E)
    if key not in _ACCUMULATORS:
        with torch.inference_mode(False):  # normal tensors: updated in and out of it
            _ACCUMULATORS[key] = (torch.zeros(E, dtype=torch.int64, device=device),
                                  torch.zeros(1, dtype=torch.int64, device=device))
    return _ACCUMULATORS[key]


def expert_loads() -> List[torch.Tensor]:
    """The tokens each expert got, summed over calls, one int64 [E] tensor a
    (device, expert count) (a host copy: a sync)."""
    return [loads.cpu() for loads, _ in _ACCUMULATORS.values()]


def device_counts() -> Dict[str, int]:
    """``max_load_sum``: the largest expert's tokens, summed over calls (a
    sync; read off the forward)."""
    return {"max_load_sum": int(sum(int(m.item()) for _, m in _ACCUMULATORS.values()))}


def _count(T: int, k: int) -> None:
    COUNTS["forwards"] += 1
    COUNTS["tokens"] += T
    COUNTS["assignments"] += T * k


def _check(x, gate_weight, w13, w2, top_k):
    if x.dim() != 2 or w13.dim() != 3 or w2.dim() != 3 or gate_weight.dim() != 2:
        raise ValueError("x [T, H], gate_weight [E, H], w13 [E, 2I, H], w2 [E, H, I] expected")
    T, H = x.shape
    E, I2, H1 = w13.shape
    if (H1 != H or gate_weight.shape != (E, H) or I2 % 2 or w2.shape != (E, H, I2 // 2)):
        raise ValueError(f"shapes x {tuple(x.shape)}, gate_weight {tuple(gate_weight.shape)}, "
                         f"w13 {tuple(w13.shape)}, w2 {tuple(w2.shape)} do not agree")
    if not 1 <= top_k <= min(E, MAX_TOP_K):
        raise ValueError(f"top_k {top_k} must lie in 1 .. min(E {E}, {MAX_TOP_K})")


def routed_experts(x: torch.Tensor, gate_weight: torch.Tensor, w13: torch.Tensor,
                   w2: torch.Tensor, top_k: int, scale: float = 1.0,
                   plain: bool = False) -> torch.Tensor:
    """The routed experts' float32 sum [T, H] (module docstring)."""
    _check(x, gate_weight, w13, w2, top_k)
    if plain or x.device.type == "cpu":
        return routed_experts_plain(x, gate_weight, w13, w2, top_k, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    T, H = x.shape
    E, I2, _ = w13.shape
    I = I2 // 2
    if E > MAX_EXPERTS or H % 8 or I % 8:
        raise ValueError(f"the expert kernels take E <= {MAX_EXPERTS} and H, I multiples of "
                         f"8; got E {E}, H {H}, I {I}")
    tensors = (x, w13, w2)
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() for t in tensors):
        raise ValueError("the expert kernels take contiguous bfloat16 x, w13 and w2")
    if any(t.device != x.device for t in (gate_weight, w13, w2)):
        raise ValueError("x and the weights must be on one device")
    _count(T, top_k)
    if T == 0:
        return x.new_zeros((0, H), dtype=torch.float32)
    dev = x.device
    lib = _build.library()
    A = T * top_k
    tiles = -(-A // ROWS_PER_TILE) + E  # enough for any split of A rows over E experts
    if tiles > 65535:
        raise ValueError(f"{T} tokens x top_{top_k} is too many for one launch")
    loads, max_sum = _accumulators(dev, E)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        with TRACER.span("tower.route"):
            logits = F.linear(x.float(), gate_weight.float()).contiguous()
            counts = torch.empty(E, dtype=torch.int32, device=dev)
            perm_tok = torch.empty((E, T), dtype=torch.int32, device=dev)
            perm_w = torch.empty((E, T), dtype=torch.float32, device=dev)
            err = lib.hc_moe_route(logits.data_ptr(), T, E, top_k, float(scale),
                                   counts.data_ptr(), perm_tok.data_ptr(), perm_w.data_ptr(),
                                   T, stream)
            _build.check(err, "hc_moe_route")
            COUNTS["launches"] += 1
        with TRACER.span("tower.experts"):
            h = torch.empty((A, I), dtype=torch.bfloat16, device=dev)
            y = torch.zeros((T, H), dtype=torch.float32, device=dev)
            err = lib.hc_moe_gemm(0, x.data_ptr(), w13.data_ptr(), counts.data_ptr(),
                                  perm_tok.data_ptr(), perm_w.data_ptr(), T, E, I2, H, tiles,
                                  h.data_ptr(), loads.data_ptr(), max_sum.data_ptr(), stream)
            _build.check(err, "hc_moe_gemm (up)")
            COUNTS["launches"] += 1
            err = lib.hc_moe_gemm(1, h.data_ptr(), w2.data_ptr(), counts.data_ptr(),
                                  perm_tok.data_ptr(), perm_w.data_ptr(), T, E, H, I, tiles,
                                  y.data_ptr(), None, None, stream)
            _build.check(err, "hc_moe_gemm (down)")
            COUNTS["launches"] += 1
    COUNTS["kernel"] += 1
    return y


def route_plain(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int,
                scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights [T, k] float32, experts [T, k] int64) of the published
    router: softmax of float32 logits, the top_k, times ``scale``."""
    probs = torch.softmax(F.linear(x.float(), gate_weight.float()), dim=-1)
    w, e = torch.topk(probs, top_k, dim=-1)
    return w * scale, e


def routed_experts_plain(x: torch.Tensor, gate_weight: torch.Tensor, w13: torch.Tensor,
                         w2: torch.Tensor, top_k: int, scale: float = 1.0) -> torch.Tensor:
    """The kernels' function in plain PyTorch: a loop over the experts that
    got tokens, ``F.linear`` in x's dtype, the float32 sum of each token's
    route-weighted expert outputs."""
    COUNTS["plain"] += 1
    T, H = x.shape
    E, I2, _ = w13.shape
    I = I2 // 2
    _count(T, top_k)
    w, experts = route_plain(x, gate_weight, top_k, scale)
    loads, max_sum = _accumulators(x.device, E)
    got = torch.bincount(experts.flatten(), minlength=E)
    loads += got
    max_sum += got.max() if T else 0
    y = torch.zeros((T, H), dtype=torch.float32, device=x.device)
    for e in range(E):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(F.linear(xe, w13[e, :I])) * F.linear(xe, w13[e, I:])
        out = F.linear(h, w2[e])
        y.index_add_(0, tok, out.float() * w[tok, slot, None])
    return y
