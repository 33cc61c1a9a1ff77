"""ANCE RoBERTa-base in plain PyTorch: the float32 forward and the int8
tower's arithmetic, from the benchmark's nested-dict weights.

Weights come in the layout the benchmark hands the port (``kernel`` [in,
out], LayerNorm ``scale`` / ``bias``, ``layers`` a list); this module
moves them to the device itself.  Both forwards pool the first token,
apply the 768 -> 768 embedding head and a LayerNorm of eps 1e-5.

* ``forward_f32``: every product in float32 (TF32 is the caller's switch:
  ``tf32(True)`` is the control's lower precision), GELU by erf.
* ``forward_int`` with ``levels`` 127: the port's int8 tower with a
  bfloat16 carry, written from its description and not from its code:
  dense kernels coded per output channel (``round(k / max|k| x levels)``,
  scale ``max|k| / levels``), activations coded per token
  (``round(x / max|x| x levels)``), exact integer products (float64
  sums), dequantized as ``acc x (row max / levels) x channel scale +
  bias`` in float32; each residual sum and LayerNorm output rounded to
  bfloat16, attention on bfloat16 q, k, v with float32 scores and softmax
  and P rounded to bfloat16, GELU by tanh on the bfloat16 product, the
  head a bfloat16 product with float32 sums.  ``levels`` 7 is the same
  arithmetic in int4, the control of the int8 configuration.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

PAD_ID = 1  # RoBERTa's <pad>: position ids count every other token
HEAD_EPS = 1e-5


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 products in cuBLAS and cuDNN inside the block (the f32
    control), off otherwise; restores the previous settings."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def to_device(params: Dict, device) -> Dict:
    """The nested dict with torch float32 leaves on ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return torch.as_tensor(params, dtype=torch.float32).to(device)


def _ln(x: torch.Tensor, p: Dict, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _embed(P: Dict, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.to(torch.int64)
    real = (ids != PAD_ID).to(torch.int64)
    pos = torch.cumsum(real, -1) * real + PAD_ID
    e = P["embeddings"]
    return e["word_embeddings"][ids] + e["position_embeddings"][pos] + e["token_type_embeddings"][0]


def _attention(q, k, v, mask, heads: int, p_dtype) -> torch.Tensor:
    """Softmax attention of [B, L, H] q, k, v (float32 scores and softmax,
    P rounded to ``p_dtype`` before the product with V)."""
    B, L, H = q.shape
    d = H // heads

    def split(t):
        return t.to(torch.float32).reshape(B, L, heads, d).transpose(1, 2)

    s = split(q) @ split(k).transpose(-1, -2) * (1.0 / math.sqrt(d))
    s = s + ((1.0 - mask.to(torch.float32)) * -1e9)[:, None, None, :]
    p = torch.softmax(s, -1).to(p_dtype).to(torch.float32)
    return (p @ split(v)).transpose(1, 2).reshape(B, L, H)


def forward_f32(P: Dict, ids: torch.Tensor, mask: torch.Tensor, heads: int = 12,
                eps: float = 1e-5) -> torch.Tensor:
    """[B, 768] float32 embeddings of the float32 tower."""
    x = _ln(_embed(P, ids), P["embeddings"]["layer_norm"], eps)
    for lyr in P["layers"]:
        a = lyr["attention"]

        def dense(t, p):
            return t @ p["kernel"] + p["bias"]

        ctx = _attention(dense(x, a["query"]), dense(x, a["key"]), dense(x, a["value"]), mask,
                         heads, torch.float32)
        x = _ln(x + dense(ctx, a["output"]), a["output_layer_norm"], eps)
        h = F.gelu(dense(x, lyr["intermediate"]))
        x = _ln(x + dense(h, lyr["output"]), lyr["output_layer_norm"], eps)
    proj = x[:, 0] @ P["embedding_head"]["kernel"] + P["embedding_head"]["bias"]
    return _ln(proj, P["norm"], HEAD_EPS)


def code_rows(x: torch.Tensor, levels: int):
    """Per-row symmetric codes of ``x`` (float32 math): (codes as float64,
    row maxima [..., 1] float32)."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(-1, keepdim=True), 1e-30)
    q = torch.clamp(torch.round(xf / s * levels), -levels, levels)
    return q.to(torch.float64), s


def code_kernel(k: torch.Tensor, levels: int):
    """A [in, out] kernel coded per output channel: (codes [in, out]
    float64, channel scale [out] float32 = max|k| / levels)."""
    s = torch.clamp_min(k.abs().amax(0), 1e-30)
    q = torch.clamp(torch.round(k / s * levels), -levels, levels)
    return q.to(torch.float64), s / levels


def int_params(P: Dict, levels: int) -> Dict:
    """The transformer layers' dense kernels coded per output channel; the
    rest stays float32."""
    def dense(p):
        q, s = code_kernel(p["kernel"], levels)
        return {"codes": q, "scale": s, "bias": p["bias"]}

    layers = []
    for lyr in P["layers"]:
        a = lyr["attention"]
        qkv = {k: torch.cat([a[n][k] for n in ("query", "key", "value")], -1)
               for k in ("kernel", "bias")}
        layers.append({
            "qkv": dense(qkv), "output": dense(a["output"]),
            "attention_ln": a["output_layer_norm"],
            "intermediate": dense(lyr["intermediate"]), "out": dense(lyr["output"]),
            "output_ln": lyr["output_layer_norm"],
        })
    return {**P, "int_layers": layers}


def _int_dense(x: torch.Tensor, p: Dict, levels: int) -> torch.Tensor:
    xq, xs = code_rows(x, levels)
    acc = (xq @ p["codes"]).to(torch.float32)  # exact integer sums, rounded once
    return acc * (xs / levels) * p["scale"] + p["bias"]


def forward_int(P: Dict, ids: torch.Tensor, mask: torch.Tensor, levels: int = 127,
                heads: int = 12, eps: float = 1e-5) -> torch.Tensor:
    """[B, 768] float32 embeddings of the int tower (``P`` from
    ``int_params`` at the same ``levels``)."""
    bf = torch.bfloat16
    x = _ln(_embed(P, ids), P["embeddings"]["layer_norm"], eps).to(bf)
    H = x.shape[-1]
    for lyr in P["int_layers"]:
        qkv = _int_dense(x, lyr["qkv"], levels).to(bf)
        ctx = _attention(qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:], mask, heads, bf).to(bf)
        out = _int_dense(ctx, lyr["output"], levels).to(bf)
        x = _ln(x + out, lyr["attention_ln"], eps).to(bf)
        g = F.gelu(_int_dense(x, lyr["intermediate"], levels).to(bf), approximate="tanh")
        y = _int_dense(g, lyr["out"], levels).to(bf)
        x = _ln(x + y, lyr["output_ln"], eps).to(bf)
    head = P["embedding_head"]
    proj = x[:, 0].to(torch.float32) @ head["kernel"].to(bf).to(torch.float32) + head["bias"]
    return _ln(proj, P["norm"], HEAD_EPS)
