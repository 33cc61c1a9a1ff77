"""DeepSeek-V2 as a query tower, in plain PyTorch and float32: the reference
the port's ``models/deepseek_v2.py`` is held against.

Plain ``torch`` only: it imports no JAX and nothing of the port (no kernel,
no packing), and sets TF32 off around its products.  It is the one
reference of this tower: the benchmark's check and the CPU tests
(tests/test_torch_deepseek_v2.py) both hold the port to it.

``Reference(cfg, params, device).embed(requests)`` runs a full forward of
each request on its own over its valid token ids, unpadded (no mask, no
cache, no batch), and returns each request's last token after the final RMSNorm,
[n, hidden] float32.  ``cfg`` is a mapping with the published
``config.json`` keys (``hidden_size``, ``num_attention_heads``,
``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
``v_head_dim``, ``rope_theta``, ``rope_scaling``, ``rms_norm_eps``,
``first_k_dense_replace``, ``moe_layer_freq``, ``num_hidden_layers``,
``num_experts_per_tok``, ``routed_scaling_factor``, ``n_shared_experts``).
``params`` are named as the port's tower names them (any float dtype, any
device); the requests go through the model layer after layer, each layer's
weights taken to float32 on ``device`` once for all of them, so bfloat16
weights of the whole model fit beside one layer's float32 copy.

The equations are those of ``modeling_deepseek.py`` (deepseek-ai/
DeepSeek-V2-Lite) and the DeepSeek-V2 paper (arXiv:2405.04434): RMSNorm
pre-norm layers; latent attention without q LoRA, its rope halves rotated
in the published layout (each interleaved pair de-interleaved, then
rotate_half) with YaRN's frequencies and attention scale; SwiGLU MLPs; the
expert layers' softmax router over float32 logits, greedy top-k, not
renormalized, times ``routed_scaling_factor``, plus the shared experts.
Departures from the published code:

* float32 throughout (the published model runs in bfloat16);
* the output is the final RMSNorm of the last token, not the LM head's
  logits (an embedding model: the LM head is dropped);
* each layer's experts are stacked (``mlp.experts.gate_up_proj`` [E, 2I,
  H]: an expert's gate rows, then its up rows; ``mlp.experts.down_proj``
  [E, H, I]) and each SwiGLU's gate and up weights are one ``gate_up_proj``
  [2I, H]; the products are the same;
* positions 0 .. l - 1 of the request alone, so no attention mask beyond
  the causal one, and no cache.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Full float32 products in cuBLAS and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def inv_freq(cfg: Mapping) -> torch.Tensor:
    """DeepseekV2YarnRotaryEmbedding's inv_freq (plain RoPE's without
    ``rope_scaling``), float32 [rope / 2]."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    pos = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** pos)
    rs = cfg.get("rope_scaling")
    if not rs:
        return freq_extra
    factor = rs["factor"]
    freq_inter = 1.0 / (factor * base ** pos)
    orig = rs["original_max_position_embeddings"]

    def correction_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    extra_mask = 1.0 - ramp
    return freq_inter * (1 - extra_mask) + freq_extra * extra_mask


def attention_scale(cfg: Mapping) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim", 0):
        m = _mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


class Reference:
    def __init__(self, cfg: Mapping, params: Dict[str, torch.Tensor], device):
        self.cfg = dict(cfg)
        self.P = params
        self.device = torch.device(device)
        rs = self.cfg.get("rope_scaling")
        self.cs_scale = 1.0 if not rs else (
            _mscale(rs["factor"], rs.get("mscale", 1))
            / _mscale(rs["factor"], rs.get("mscale_all_dim", 0)))

    def layer_weights(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i's weights in float32 on the device, by their names less
        the ``layers.<i>.`` prefix."""
        p = f"layers.{i}."
        return {n[len(p):]: t.to(self.device, torch.float32)
                for n, t in self.P.items() if n.startswith(p)}

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return w * (x * torch.rsqrt(var + self.cfg["rms_norm_eps"]))

    def rope(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """x [h, l, d] in the published layout."""
        h, l, d = x.shape
        x = x.view(h, l, d // 2, 2).transpose(3, 2).reshape(h, l, d)
        rotated = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
        return x * cos + rotated * sin

    def attention(self, x: torch.Tensor, W: Dict[str, torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        l = x.shape[0]
        nh, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
        q = (x @ W["self_attn.q_proj.weight"].T).view(l, nh, dn + dr).transpose(0, 1)
        q_nope, q_pe = torch.split(q, [dn, dr], dim=-1)
        ckv = x @ W["self_attn.kv_a_proj_with_mqa.weight"].T
        ckv, k_pe = torch.split(ckv, [c["kv_lora_rank"], dr], dim=-1)
        k_pe = k_pe.view(l, 1, dr).transpose(0, 1)
        kv = self.norm(ckv, W["self_attn.kv_a_layernorm.weight"]) @ W["self_attn.kv_b_proj.weight"].T
        kv = kv.view(l, nh, dn + dv).transpose(0, 1)
        k_nope, v = torch.split(kv, [dn, dv], dim=-1)
        t = torch.arange(l, dtype=torch.float32, device=self.device)
        freqs = torch.outer(t, inv_freq(c).to(self.device))
        emb = torch.cat((freqs, freqs), dim=-1)
        cos, sin = emb.cos() * self.cs_scale, emb.sin() * self.cs_scale
        q_pe, k_pe = self.rope(q_pe, cos, sin), self.rope(k_pe, cos, sin)
        qs = torch.cat([q_nope, q_pe], dim=-1)
        ks = torch.cat([k_nope, k_pe.expand(nh, l, dr)], dim=-1)
        s = (qs @ ks.transpose(1, 2)) * attention_scale(c)
        causal = torch.ones((l, l), dtype=torch.bool, device=self.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.softmax(s, dim=-1) @ v  # [nh, l, dv]
        return o.transpose(0, 1).reshape(l, nh * dv) @ W["self_attn.o_proj.weight"].T

    def swiglu(self, x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
        g, u = (x @ gate_up.T).chunk(2, dim=-1)
        return (F.silu(g) * u) @ down.T

    def experts(self, x: torch.Tensor, W: Dict[str, torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        k = c["num_experts_per_tok"]
        scores = torch.softmax(x @ W["mlp.gate.weight"].T, dim=-1)
        weight, idx = torch.topk(scores, k, dim=-1)
        weight = weight * c["routed_scaling_factor"]
        gate_up, down = W["mlp.experts.gate_up_proj"], W["mlp.experts.down_proj"]
        flat = idx.flatten()
        order = torch.argsort(flat, stable=True)  # the assignments grouped by expert
        tok, w = order // k, weight.flatten()[order]
        counts = torch.bincount(flat, minlength=gate_up.shape[0]).tolist()
        y = torch.zeros_like(x)
        a = 0
        for e, n in enumerate(counts):
            if n:
                t = tok[a:a + n]
                y.index_add_(0, t, self.swiglu(x[t], gate_up[e], down[e]) * w[a:a + n, None])
                a += n
        if c["n_shared_experts"]:
            y = y + self.swiglu(x, W["mlp.shared_experts.gate_up_proj.weight"],
                                W["mlp.shared_experts.down_proj.weight"])
        return y

    def layer(self, x: torch.Tensor, W: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
        """Decoder layer i on one request's hidden states [l, hidden]."""
        c = self.cfg
        x = x + self.attention(self.norm(x, W["input_layernorm.weight"]), W)
        h = self.norm(x, W["post_attention_layernorm.weight"])
        if i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0:
            return x + self.experts(h, W)
        return x + self.swiglu(h, W["mlp.gate_up_proj.weight"], W["mlp.down_proj.weight"])

    @torch.inference_mode()
    def embed(self, requests: Sequence[Sequence[int]]) -> torch.Tensor:
        """[n, hidden] float32: each request's valid token ids, each request
        forward on its own, layer after layer (a layer's weights taken to
        float32 once for every request)."""
        table = self.P["embed_tokens.weight"]
        with no_tf32():
            xs = [table[torch.as_tensor(list(ids), dtype=torch.int64).to(table.device)]
                  .to(self.device, torch.float32) for ids in requests]
            for i in range(self.cfg["num_hidden_layers"]):
                W = self.layer_weights(i)
                xs = [self.layer(x, W, i) for x in xs]
                del W
            final = self.P["norm.weight"].to(self.device, torch.float32)
            out: List[torch.Tensor] = [self.norm(x[-1:], final)[0] for x in xs]
        return torch.stack(out)
