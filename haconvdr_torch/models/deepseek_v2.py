"""A DeepSeek-V2 decoder as the conversational query tower: the published
model (``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite, the
DeepSeek-V2 paper, arXiv:2405.04434) run as an embedding model, as
LLM-based dense retrievers such as RepLLaMA (arXiv:2310.08319) run a
decoder: the final RMSNorm of each query's last valid token, ``[B, H]``
float32, scored by inner product.  No LM head, no cache, no decode.

``DeepseekV2Encoder(cfg)(input_ids, attention_mask, host_mask=)`` is called
as ``AnceEncoder`` is.  Its layers, as published:

* pre-norm decoder layers, RMSNorm (float32 statistics, ``weight * x`` in
  the weights' dtype) before attention and before the MLP, then the residual
  add;
* multi-head latent attention without q LoRA: q = x Wq ([nh, nope + rope]);
  [c, k_rope] = x Wkv_a; [k_nope, v] = RMSNorm(c) Wkv_b; the rope halves of
  q and k (k's shared by the heads) rotated in the published layout (each
  interleaved pair de-interleaved, then ``rotate_half``) with YaRN's
  frequencies (the ramp between ``beta_fast`` and ``beta_slow`` rotations
  of the original context; cos and sin times mscale(f, mscale) /
  mscale(f, mscale_all_dim)), softmax scale (nope + rope)^-0.5 x
  mscale(f, mscale_all_dim)^2; causal, keys masked; o = ctx Wo;
* the first ``first_k_dense_replace`` layers a SwiGLU MLP, the rest
  mixture-of-experts layers: the routed experts (``ops.moe.routed_experts``:
  float32 router logits and softmax, greedy top-k, not renormalized, times
  ``routed_scaling_factor``) plus the shared experts as one dense SwiGLU of
  width ``n_shared_experts x moe_intermediate_size``.

Weights are bfloat16 (``cfg.dtype``); every product accumulates in float32
and rounds to bfloat16, as the published bfloat16 model does.  One
departure: the residual stream is float32 (the published model's is
bfloat16): each sub-layer's bfloat16 output (the routed experts' float32
sum unrounded) is added to a float32 stream, and the final RMSNorm stays in
float32.  A bfloat16 stream rounds every one of its 54 adds to 2^-9 of the
stream; over 27 layers of random weights that noise grew to the size of a
fault the check has to see (PERF.md §2).

The forward packs (``ops.pack``): the plan, from the host mask, keeps each
row's span up to its last valid token, and every token-wise layer (the
embedding, the norms, every projection, the router and the experts) runs on
those ``T`` rows only.  Attention scatters the packed q, k and v rows into
``[B, L']`` buffers (``L'`` the longest span rounded up to 16; zeroed once a
forward) and runs causally there with the keys masked, through
``F.scaled_dot_product_attention``.  The embedding is the packed row
``starts[b] + lengths[b] - 1`` after the final norm.  Nothing in the
forward reads the device back.

Parameters (``from_params`` takes them by these names, torch tensors, which
stay where they are when they already have the device and dtype, or
numpy): ``embed_tokens.weight``; per layer ``input_layernorm.weight``,
``self_attn.{q_proj, kv_a_proj_with_mqa, kv_b_proj, o_proj}.weight``,
``self_attn.kv_a_layernorm.weight``, ``post_attention_layernorm.weight``;
dense layers ``mlp.gate_up_proj.weight`` ([2I, H]: the gate rows, then the
up rows) and ``mlp.down_proj.weight``; expert layers ``mlp.gate.weight``
[E, H], ``mlp.experts.gate_up_proj`` [E, 2I, H], ``mlp.experts.down_proj``
[E, H, I] and ``mlp.shared_experts.{gate_up_proj, down_proj}.weight``;
``norm.weight``.  The published per-expert ``gate_proj`` / ``up_proj`` /
``down_proj`` weights are these stacked.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from haconvdr_torch.config import DeepseekV2Config
from haconvdr_torch.device import DeviceLike, resolve_device, torch_dtype
from haconvdr_torch.ops import moe, pack


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """DeepseekV2RMSNorm: float32 statistics, ``weight * x`` in the weight's
    dtype (the published code's, whose stream has the weights' dtype)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * xf.to(weight.dtype)


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """float32 [rope / 2]: YaRN's frequencies (plain RoPE without scaling)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    rs = cfg.rope_scaling
    if not rs:
        return extra
    f = rs["factor"]
    inter = 1.0 / (f * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(cfg: DeepseekV2Config) -> float:
    s = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    rs = cfg.rope_scaling
    if rs and rs.get("mscale_all_dim", 0):
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        s = s * m * m
    return s


def _cos_sin_scale(cfg: DeepseekV2Config) -> float:
    rs = cfg.rope_scaling
    if not rs:
        return 1.0
    return yarn_mscale(rs["factor"], rs.get("mscale", 1)) / yarn_mscale(
        rs["factor"], rs.get("mscale_all_dim", 0))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The published apply_rotary_pos_emb on x [T, h, d] with cos, sin
    [T, d]: each interleaved pair de-interleaved, then x cos +
    rotate_half(x) sin."""
    T, h, d = x.shape
    x = x.reshape(T, h, d // 2, 2).transpose(-1, -2).reshape(T, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _check_cfg(cfg: DeepseekV2Config) -> None:
    if cfg.q_lora_rank:
        raise ValueError("q LoRA (q_lora_rank) is not built")
    if cfg.scoring_func != "softmax" or cfg.topk_method != "greedy" or cfg.norm_topk_prob:
        raise ValueError("only softmax scoring, greedy top-k without renormalization is built")
    if cfg.rope_scaling and cfg.rope_scaling.get("type", "yarn") != "yarn":
        raise ValueError(f"rope_scaling {cfg.rope_scaling.get('type')!r} is not built")


class RMSNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)) with gate and up as one [2I, H] weight."""

    def __init__(self, H: int, I: int):
        super().__init__()
        self.gate_up_proj = nn.Linear(H, 2 * I, bias=False)
        self.down_proj = nn.Linear(I, H, bias=False)

    def forward(self, x):
        g, u = F.linear(x, self.gate_up_proj.weight).chunk(2, dim=-1)
        return F.linear(F.silu(g) * u, self.down_proj.weight)


class Experts(nn.Module):
    def __init__(self, E: int, H: int, I: int):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(E, 2 * I, H))
        self.down_proj = nn.Parameter(torch.empty(E, H, I))


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = nn.Linear(H, cfg.n_routed_experts, bias=False)
        self.experts = Experts(cfg.n_routed_experts, H, I)
        self.shared_experts = SwiGLU(H, I * cfg.n_shared_experts) if cfg.n_shared_experts else None
        self.plain = False

    def forward(self, x):
        cfg = self.cfg
        y = moe.routed_experts(x, self.gate.weight, self.experts.gate_up_proj,
                               self.experts.down_proj, cfg.num_experts_per_tok,
                               cfg.routed_scaling_factor, plain=self.plain)
        return y if self.shared_experts is None else y + self.shared_experts(x)


class Attention(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        H, nh = cfg.hidden_size, cfg.num_attention_heads
        dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        self.q_proj = nn.Linear(H, nh * (dn + dr), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(H, r + dr, bias=False)
        self.kv_a_layernorm = RMSNorm(r)
        self.kv_b_proj = nn.Linear(r, nh * (dn + dv), bias=False)
        self.o_proj = nn.Linear(nh * dv, H, bias=False)
        self.scale = softmax_scale(cfg)

    def forward(self, x, fwd: "_Forward"):
        cfg = self.cfg
        T = x.shape[0]
        nh, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        q = F.linear(x, self.q_proj.weight).view(T, nh, dn + dr)
        c, k_rope = F.linear(x, self.kv_a_proj_with_mqa.weight).split([cfg.kv_lora_rank, dr], -1)
        kv = F.linear(rms_norm(c, self.kv_a_layernorm.weight, cfg.rms_norm_eps),
                      self.kv_b_proj.weight).view(T, nh, dn + dv)
        k_nope, v = kv.split([dn, dv], -1)
        q_rope = rotate(q[..., dn:], fwd.cos, fwd.sin)
        k_rope = rotate(k_rope.reshape(T, 1, dr), fwd.cos, fwd.sin)
        qs = torch.cat([q[..., :dn], q_rope], -1).reshape(T, -1)
        ks = torch.cat([k_nope, k_rope.expand(T, nh, dr)], -1).reshape(T, -1)
        ctx = fwd.attend(qs, ks, v.reshape(T, -1), nh, self.scale)
        return F.linear(ctx, self.o_proj.weight)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, expert_layer: bool):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)
        self.mlp = MoE(cfg) if expert_layer else SwiGLU(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x, fwd):
        eps = self.cfg.rms_norm_eps
        x = x + self.self_attn(rms_norm(x, self.input_layernorm.weight, eps), fwd)
        return x + self.mlp(rms_norm(x, self.post_attention_layernorm.weight, eps))


class _Forward:
    """One packed forward's layout: the positions' cos and sin, and the
    attention buffers and mask of the trimmed ``[B, L']`` batch."""

    def __init__(self, enc: "DeepseekV2Encoder", key_mask: torch.Tensor, kept: torch.Tensor):
        B, W = key_mask.shape
        self.B, self.W, self.kept = B, W, kept
        cos, sin = enc.cos_sin(W, kept.device)
        pos = kept % W
        self.cos, self.sin = cos.index_select(0, pos), sin.index_select(0, pos)
        causal = torch.ones((W, W), dtype=torch.bool, device=kept.device).tril_()
        eye = torch.eye(W, dtype=torch.bool, device=kept.device)
        # a query sees the keys before it that the mask keeps, and itself (so
        # a row with no valid key, which the plan keeps at one position,
        # stays finite)
        self.allowed = (causal & (key_mask.bool()[:, None, :] | eye))[:, None]
        self._bufs: Dict[Tuple[int, torch.dtype], torch.Tensor] = {}

    def _buf(self, slot: int, cols: int, dtype) -> torch.Tensor:
        key = (slot, dtype)
        if key not in self._bufs:
            self._bufs[key] = torch.zeros((self.B * self.W, cols), dtype=dtype,
                                          device=self.kept.device)
        return self._bufs[key]

    def attend(self, q, k, v, nh: int, scale: float) -> torch.Tensor:
        """Packed q [T, nh dq], k [T, nh dq], v [T, nh dv] -> the packed context
        [T, nh dv]."""
        B, W = self.B, self.W

        def heads(i, t):
            buf = pack.scatter(self._buf(i, t.shape[1], t.dtype), self.kept, t)
            return buf.view(B, W, nh, -1).transpose(1, 2)

        ctx = F.scaled_dot_product_attention(heads(0, q), heads(1, k), heads(2, v),
                                             attn_mask=self.allowed, scale=scale)
        return pack.gather(ctx.transpose(1, 2), self.kept).reshape(-1, v.shape[1])


class DeepseekV2Encoder(nn.Module):
    """DeepSeek-V2 decoder -> last valid token -> final RMSNorm; [B, H]
    float32 (module docstring).  ``plain=True`` runs the expert layers'
    plain twin on any device (the reference a kernel run is held
    against)."""

    def __init__(self, cfg: DeepseekV2Config, plain: bool = False):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i >= cfg.first_k_dense_replace and i % cfg.moe_layer_freq == 0)
            for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size)
        self._rope: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.plain = plain

    @property
    def plain(self) -> bool:
        return self._plain

    @plain.setter
    def plain(self, value: bool) -> None:
        self._plain = bool(value)
        for m in self.modules():
            if isinstance(m, MoE):
                m.plain = self._plain

    @classmethod
    def from_params(cls, params: Dict, cfg: DeepseekV2Config, device: DeviceLike = None,
                    plain: bool = False) -> "DeepseekV2Encoder":
        """Build from ``params`` (module docstring's names) without a random
        init.  A tensor already on the device in ``cfg.dtype`` is taken as
        it is (no copy); others are cast and moved."""
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        sd = {}
        for name, v in params.items():
            t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
            sd[name] = t.to(device=dev, dtype=dtype)
        with torch.device("meta"):
            enc = cls(cfg, plain=plain)
        enc.load_state_dict(sd, assign=True)
        return enc.requires_grad_(False).eval()

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def cos_sin(self, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """cos and sin [>= n, rope] in the weights' dtype (the published
        cache: float32 angles, rounded once), cached a device."""
        have = self._rope.get(device)
        if have is None or have[0].shape[0] < n:
            size = max(n, 512)
            inv = rope_inv_freq(self.cfg).to(device)
            freqs = torch.outer(torch.arange(size, dtype=torch.float32, device=device), inv)
            emb = torch.cat([freqs, freqs], dim=-1)
            m = _cos_sin_scale(self.cfg)
            dt = self.embed_tokens.weight.dtype
            have = ((emb.cos() * m).to(dt), (emb.sin() * m).to(dt))
            self._rope[device] = have
        return have

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                host_mask=None) -> torch.Tensor:
        plan = pack.plan_of(attention_mask, host_mask)
        dev = self.device
        W = plan.width
        kept, starts = plan.to(dev)
        ids = input_ids[:, :W].to(dev).reshape(-1).index_select(0, kept).to(torch.int64)
        key_mask = attention_mask[:, :W].to(dev)
        fwd = _Forward(self, key_mask, kept)
        x = F.embedding(ids, self.embed_tokens.weight).float()  # the float32 stream
        for layer in self.layers:
            x = layer(x, fwd)
        ends = torch.cat([starts[1:], starts.new_full((1,), plan.rows)]) - 1
        return rms_norm(x.index_select(0, ends), self.norm.weight.float(), self.cfg.rms_norm_eps)
