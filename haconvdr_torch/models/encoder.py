"""ANCE RoBERTa query tower, inference forward (counterpart of
haconvdr_tpu/models/encoder.py:encode).

Numerics follow the reference: parameters are float32; dense layers run in
``cfg.dtype`` with float32 accumulation and the bias added in float32;
LayerNorm statistics are float32; the residual carry is
promote(dtype, bfloat16); GELU is erf in float32 and tanh in bfloat16; the
padding bias is additive -1e9.  Each layer's attention goes through one
fused QKV projection ``[B, L, 3H]`` straight into
``ops.fused_attention.fused_attention_qkv`` (the CUDA kernel on CUDA
tensors), so no head transposes happen around it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from haconvdr_tpu.config import ModelConfig
from haconvdr_torch.device import DeviceLike, resolve_device, torch_dtype
from haconvdr_torch.models.convert import params_from_jax
from haconvdr_torch.ops.fused_attention import fused_attention_qkv

AttentionFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """Pads get ``pad_token_id``; real tokens ``pad_token_id + running
    index`` (HF create_position_ids_from_input_ids).  Compares against
    ``pad_token_id`` (1) although ConcatBuilder pads with 0, as the
    reference does."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=-1) * mask + pad_token_id


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _dense(x, lin: nn.Linear, dtype, out_dtype=None):
    """x @ W in ``dtype``, accumulated and biased in promote(dtype, f32)."""
    acc = _acc(dtype)
    y = F.linear(x.to(dtype), lin.weight.to(dtype)).to(acc) + lin.bias.to(acc)
    return y if out_dtype is None else y.to(out_dtype)


def _layer_norm(x, ln: nn.LayerNorm, eps: float, out_dtype=None):
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * ln.weight.to(y.dtype) + ln.bias.to(y.dtype)
    return y if out_dtype is None else y.to(out_dtype)


class AnceLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.attention = nn.ModuleDict(
            {
                "qkv": nn.Linear(H, 3 * H),  # [q | k | v] kernels, fused
                "output": nn.Linear(H, H),
                "output_layer_norm": nn.LayerNorm(H),
            }
        )
        self.intermediate = nn.Linear(H, I)
        self.output = nn.Linear(I, H)
        self.output_layer_norm = nn.LayerNorm(H)


class AnceEncoder(nn.Module):
    """RoBERTa/BERT transformer + ANCE ``embeddingHead`` + LayerNorm.

    ``forward(input_ids, attention_mask)`` -> [B, embedding_dim] float32.
    ``attention`` replaces the attention function (default: the
    dispatching kernel wrapper); it exists so that a reference run can
    name the plain twin explicitly.
    """

    def __init__(self, cfg: ModelConfig, attention: Optional[AttentionFn] = None):
        super().__init__()
        self.cfg = cfg
        self.attention = attention or fused_attention_qkv
        H = cfg.hidden_size
        self.embeddings = nn.ModuleDict(
            {
                "word_embeddings": nn.Embedding(cfg.vocab_size, H),
                "position_embeddings": nn.Embedding(cfg.max_position_embeddings, H),
                "token_type_embeddings": nn.Embedding(cfg.type_vocab_size, H),
                "layer_norm": nn.LayerNorm(H),
            }
        )
        self.layers = nn.ModuleList(AnceLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.embedding_head = nn.Linear(H, cfg.embedding_dim)
        self.norm = nn.LayerNorm(cfg.embedding_dim)

    @classmethod
    def from_jax_params(
        cls,
        params,
        cfg: ModelConfig,
        device: DeviceLike = None,
        attention: Optional[AttentionFn] = None,
    ) -> "AnceEncoder":
        """Build from the JAX package's nested-dict params (numpy leaves)
        without a throwaway random init."""
        with torch.device("meta"):
            enc = cls(cfg, attention=attention)
        enc.load_state_dict(params_from_jax(params), assign=True)
        return enc.to(resolve_device(device)).eval()

    def hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        carry = torch.promote_types(dtype, torch.bfloat16)  # residual carry
        eps = cfg.layer_norm_eps
        emb = self.embeddings
        if cfg.model_type.upper().startswith("BERT"):
            pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        else:
            pos = roberta_position_ids(input_ids, cfg.pad_token_id)
        x = (
            emb["word_embeddings"](input_ids)
            + emb["position_embeddings"](pos)
            + emb["token_type_embeddings"](torch.zeros_like(input_ids))
        )
        x = _layer_norm(x, emb["layer_norm"], eps, out_dtype=carry)
        gelu = "tanh" if dtype == torch.bfloat16 else "none"
        for layer in self.layers:
            att = layer.attention
            qkv = _dense(x, att["qkv"], dtype, out_dtype=dtype).contiguous()
            ctx = self.attention(qkv, attention_mask, cfg.num_attention_heads)
            x = _layer_norm(
                x + _dense(ctx, att["output"], dtype).to(x.dtype),
                att["output_layer_norm"], eps, out_dtype=carry,
            )
            inter = F.gelu(
                _dense(x, layer.intermediate, dtype, out_dtype=dtype), approximate=gelu
            )
            x = _layer_norm(
                x + _dense(inter, layer.output, dtype).to(x.dtype),
                layer.output_layer_norm, eps, out_dtype=carry,
            )
        return x

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        use_mean: bool = False,
    ) -> torch.Tensor:
        """encoder -> CLS (or masked-mean) pooling -> embeddingHead ->
        LayerNorm(eps 1e-5); [B, embedding_dim] float32
        (haconvdr_tpu/models/encoder.py:489-519)."""
        input_ids = input_ids.to(torch.int64)
        hidden = self.hidden_states(input_ids, attention_mask)
        if use_mean:
            m = attention_mask.to(torch.float32)[:, :, None]
            pooled = (hidden * m).sum(dim=1) / m.sum(dim=1)
        else:
            pooled = hidden[:, 0]
        proj = _dense(pooled, self.embedding_head, torch_dtype(self.cfg.dtype))
        return _layer_norm(proj, self.norm, 1e-5)
