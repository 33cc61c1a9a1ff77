"""ANCE RoBERTa query/passage tower, inference forward (counterpart of
haconvdr_tpu/models/encoder.py:encode).

Numerics follow the reference: parameters are float32; float dense
layers multiply ``cfg.dtype``-rounded operands with float32 accumulation
(the products of bfloat16 operands are exact in float32) and add the bias
in float32, rounding once to ``out_dtype``; LayerNorm statistics are
float32; the residual carry is promote(dtype, bfloat16); GELU is erf in
float32 and tanh in bfloat16; the padding bias is additive -1e9.  Each
layer's attention goes through one fused QKV projection ``[B, L, 3H]``
straight into ``ops.fused_attention.fused_attention_qkv`` (the CUDA kernel
on CUDA tensors), so no head transposes happen around it.

int8 towers (``quantize_encoder_params``): the transformer layers' dense
kernels are int8 per output channel (``Int8Linear``), activations are
quantized per token, dynamically, and multiplied with exact int32
accumulation.  With a bfloat16 carry the tower routes as the reference's
gates do (haconvdr_tpu/models/encoder.py:345-368): every LayerNorm also
emits its output's int8 codes (``ops.fused_ln.fused_residual_ln_quant``),
which the next dense takes as ``prequant``, and each MLP block is one
kernel (``ops.fused_mlp.fused_mlp_block``); the carry through the layers is
``(x, xq, xs)``.  With a float32 carry, int8 kernels take the unfused int8
dense and no fused kernel, as the reference does.  The module is
inference-only, so no training gate applies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from haconvdr_torch.config import ModelConfig
from haconvdr_torch.device import DeviceLike, resolve_device, torch_dtype
from haconvdr_torch.index.quantize import quantize_rows
from haconvdr_torch.models.convert import params_from_jax
from haconvdr_torch.ops import fused_attention, fused_ln, fused_mlp
from haconvdr_torch.ops.fused_ln import layer_norm


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """Pads get ``pad_token_id``; real tokens ``pad_token_id + running
    index`` (HF create_position_ids_from_input_ids).  Compares against
    ``pad_token_id`` (1) although ConcatBuilder pads with 0, as the
    reference does."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=-1) * mask + pad_token_id


def quantize_encoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize the transformer layers' dense kernels per output
    channel, on the JAX package's numpy params (list or stacked layout):
    codes and scales bit-identical to
    haconvdr_tpu/models/encoder.py:quantize_encoder_params.  Embeddings,
    LayerNorms and the embedding head stay float32.

    Idempotent, unlike the reference: a dense dict that already has a
    ``kernel_scale`` passes through unchanged (quantizing its int8 codes
    again would overwrite the scales with max|code| / 127)."""

    def quant_tree(t):
        if isinstance(t, dict):
            if "kernel_scale" in t:
                return t
            if "kernel" in t and np.ndim(t["kernel"]) >= 2:
                k = np.asarray(t["kernel"], np.float32)
                scale = np.maximum(np.max(np.abs(k), axis=-2, keepdims=True), np.float32(1e-30))
                kq = np.clip(np.round(k / scale * np.float32(127.0)), -127, 127).astype(np.int8)
                ks = (scale / np.float32(127.0)).reshape(scale.shape[:-2] + scale.shape[-1:])
                return {**t, "kernel": kq, "kernel_scale": ks}
            return {kk: quant_tree(v) for kk, v in t.items()}
        if isinstance(t, list):
            return [quant_tree(v) for v in t]
        return t

    return {**params, "layers": quant_tree(params["layers"])}


class Int8Linear(nn.Module):
    """Inference int8 dense: ``weight`` int8 [out, in] (nn.Linear's layout),
    per-output-channel ``kernel_scale`` and ``bias`` float32 [out]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.zeros(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    def forward(self, x: torch.Tensor, prequant=None, out_dtype=None) -> torch.Tensor:
        """float32 (or ``out_dtype``) ``x @ W^T``; ``prequant=(xq, xs)``
        skips the dynamic per-token quantization of x."""
        xq, xs = quantize_rows(x) if prequant is None else prequant
        y = fused_mlp.int8_dense(xq, xs, self.weight, self.kernel_scale, self.bias)
        return y if out_dtype is None else y.to(out_dtype)


def _dense(x, lin, dtype, out_dtype=None, prequant=None):
    """One dense layer.  int8: ``Int8Linear``.  float: x @ W of the
    ``dtype``-rounded operands, accumulated and biased in
    promote(dtype, f32), rounded once to ``out_dtype``.  bfloat16 on CUDA
    is one bf16 GEMM with a float32 result (``torch.mm(out_dtype=)``);
    elsewhere a float32 product of the rounded operands (exact products,
    float32 sums; TF32 is off, device.py)."""
    if isinstance(lin, Int8Linear):
        return lin(x, prequant, out_dtype)
    acc = torch.promote_types(dtype, torch.float32)
    w = lin.weight.to(dtype)
    if dtype == torch.bfloat16 and x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]).to(dtype), w.t(), out_dtype=acc)
        y = y.reshape(*x.shape[:-1], w.shape[0])
    else:
        y = F.linear(x.to(dtype).to(acc), w.to(acc))
    y = y + lin.bias.to(acc)
    return y if out_dtype is None else y.to(out_dtype)


class AnceLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, int8: bool = False):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        linear = Int8Linear if int8 else nn.Linear
        self.attention = nn.ModuleDict(
            {
                "qkv": linear(H, 3 * H),  # [q | k | v] kernels (and scales), fused
                "output": linear(H, H),
                "output_layer_norm": nn.LayerNorm(H),
            }
        )
        self.intermediate = linear(H, I)
        self.output = linear(I, H)
        self.output_layer_norm = nn.LayerNorm(H)


class AnceEncoder(nn.Module):
    """RoBERTa/BERT transformer + ANCE ``embeddingHead`` + LayerNorm.

    ``forward(input_ids, attention_mask)`` -> [B, embedding_dim] float32.
    ``int8`` builds the int8 tower (``from_jax_params`` decides it from the
    params).  ``plain=True`` runs every kernel's plain twin on any device
    (the reference a kernel run is held against); the default dispatches
    on the tensors' device.
    """

    def __init__(self, cfg: ModelConfig, int8: bool = False, plain: bool = False):
        super().__init__()
        self.cfg = cfg
        self.int8 = int8
        self.plain = plain
        H = cfg.hidden_size
        self.embeddings = nn.ModuleDict(
            {
                "word_embeddings": nn.Embedding(cfg.vocab_size, H),
                "position_embeddings": nn.Embedding(cfg.max_position_embeddings, H),
                "token_type_embeddings": nn.Embedding(cfg.type_vocab_size, H),
                "layer_norm": nn.LayerNorm(H),
            }
        )
        self.layers = nn.ModuleList(AnceLayer(cfg, int8) for _ in range(cfg.num_hidden_layers))
        self.embedding_head = nn.Linear(H, cfg.embedding_dim)
        self.norm = nn.LayerNorm(cfg.embedding_dim)

    @classmethod
    def from_jax_params(
        cls, params, cfg: ModelConfig, device: DeviceLike = None, plain: bool = False,
    ) -> "AnceEncoder":
        """Build from the JAX package's nested-dict params (numpy leaves,
        float or int8-quantized) without a throwaway random init.  The
        embedding width is the head's, as in the JAX ``encode`` (an HF
        ``config.json`` does not record it: ``config_from_hf``)."""
        sd = params_from_jax(params)
        emb_dim = sd["embedding_head.weight"].shape[0]
        if emb_dim != cfg.embedding_dim:
            cfg = dataclasses.replace(cfg, embedding_dim=emb_dim)
        with torch.device("meta"):
            enc = cls(cfg, int8="layers.0.attention.qkv.kernel_scale" in sd, plain=plain)
        enc.load_state_dict(sd, assign=True)
        return enc.to(resolve_device(device)).eval()

    def hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        carry = torch.promote_types(dtype, torch.bfloat16)  # residual carry
        eps = cfg.layer_norm_eps
        plain = self.plain
        attention = (
            fused_attention.fused_attention_qkv_plain if plain
            else fused_attention.fused_attention_qkv
        )
        ln_quant = (
            fused_ln.fused_residual_ln_quant_plain if plain
            else fused_ln.fused_residual_ln_quant
        )
        mlp_block = fused_mlp.fused_mlp_block_plain if plain else fused_mlp.fused_mlp_block
        # the reference's gates (encoder.py:345-368), less the TPU-only ones
        use_fused_quant = cfg.use_fused_ln and carry == torch.bfloat16 and self.int8
        use_fused_mlp = use_fused_quant and cfg.use_fused_mlp

        def res_ln(x, branch_out, ln):
            """(LayerNorm(x + branch_out), prequant) in the carry dtype; the
            branch output is cast to the carry before the add."""
            if use_fused_quant:
                y, yq, ys = ln_quant(
                    x, branch_out.to(x.dtype), ln.weight, ln.bias, eps, out_dtype=carry
                )
                return y, (yq, ys)
            return layer_norm(x + branch_out.to(x.dtype), ln.weight, ln.bias, eps, carry), None

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
        ln = emb["layer_norm"]
        if use_fused_quant:  # float32 input, no residual
            x, xq, xs = ln_quant(x, None, ln.weight, ln.bias, eps, out_dtype=carry)
            pq = (xq, xs)
        else:
            x, pq = layer_norm(x, ln.weight, ln.bias, eps, carry), None
        gelu = "tanh" if dtype == torch.bfloat16 else "none"
        for layer in self.layers:
            att = layer.attention
            qkv = _dense(x, att["qkv"], dtype, out_dtype=dtype, prequant=pq).contiguous()
            ctx = attention(qkv, attention_mask, cfg.num_attention_heads)
            x, pq = res_ln(x, _dense(ctx, att["output"], dtype), att["output_layer_norm"])
            if use_fused_mlp:
                ffn, out, ln = layer.intermediate, layer.output, layer.output_layer_norm
                x, xq, xs = mlp_block(
                    x, pq[0], pq[1], ffn.weight, ffn.kernel_scale, ffn.bias,
                    out.weight, out.kernel_scale, out.bias, ln.weight, ln.bias,
                    eps=eps, out_dtype=carry,
                )
                pq = (xq, xs)
                continue
            inter = F.gelu(
                _dense(x, layer.intermediate, dtype, out_dtype=dtype, prequant=pq),
                approximate=gelu,
            )
            x, pq = res_ln(x, _dense(inter, layer.output, dtype), layer.output_layer_norm)
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
        return layer_norm(proj, self.norm.weight, self.norm.bias, 1e-5)
