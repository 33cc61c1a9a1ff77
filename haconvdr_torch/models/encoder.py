"""ANCE RoBERTa query/passage tower (counterpart of
haconvdr_tpu/models/encoder.py:encode), inference and train mode.

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
dense and no fused kernel, as the reference does.  int8 towers are
inference-only: a trainable int8 tower raises.

Train mode (``forward(..., dropout=generator, trainable=True)``,
haconvdr_tpu/models/encoder.py:283-300): ``trainable`` routes attention to
the differentiable ``ops.flash_attention`` kernels (never to the inference
kernel, which has no gradient), with or without dropout; a dropout
generator (None means eval) turns on attention-probs dropout inside those
kernels and hidden dropout where JAX puts it (after the embedding
LayerNorm, on the attention output, on the MLP output).  Every mask comes
from seeds drawn from the generator at the start of the forward: the
attention words go to the kernels' hash, and each hidden mask is drawn
from a generator made from its own seed where it is applied, so a
checkpointed block (``cfg.remat``: ``"mlp"`` the MLP block, ``True`` the
whole layer) draws the same mask when it is recomputed.  JAX draws the
hidden masks from the TPU's ``rbg`` bits, which cannot be matched, so the
parity tests run with dropout off.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from haconvdr_torch.config import ModelConfig
from haconvdr_torch.device import DeviceLike, resolve_device, torch_dtype
from haconvdr_torch.index.quantize import quantize_rows
from haconvdr_torch.models.convert import params_from_jax
from haconvdr_torch.ops import flash_attention, fused_attention, fused_ln, fused_mlp
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


class _MmF32(torch.autograd.Function):
    """``x @ w^T`` of bf16 operands with a float32 result (one bf16 GEMM,
    ``torch.mm(out_dtype=float32)``), differentiable: ``aten::mm.dtype``
    has no derivative.  The backward is two bf16 GEMMs with float32
    results, cast to the operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g, w, out_dtype=torch.float32).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(g.t(), x, out_dtype=torch.float32).to(w.dtype)
        return gx, gw


def _dense(x, lin, dtype, out_dtype=None, prequant=None):
    """One dense layer.  int8: ``Int8Linear``.  float: x @ W of the
    ``dtype``-rounded operands, accumulated and biased in
    promote(dtype, f32), rounded once to ``out_dtype``.  bfloat16 on CUDA
    is one bf16 GEMM with a float32 result (``_MmF32``); elsewhere a
    float32 product of the rounded operands (exact products, float32 sums;
    TF32 is off, device.py)."""
    if isinstance(lin, Int8Linear):
        return lin(x, prequant, out_dtype)
    acc = torch.promote_types(dtype, torch.float32)
    w = lin.weight.to(dtype)
    if dtype == torch.bfloat16 and x.is_cuda:
        y = _MmF32.apply(x.reshape(-1, x.shape[-1]).to(dtype), w)
        y = y.reshape(*x.shape[:-1], w.shape[0])
    else:
        y = F.linear(x.to(dtype).to(acc), w.to(acc))
    y = y + lin.bias.to(acc)
    return y if out_dtype is None else y.to(out_dtype)


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Inverted dropout, a no-op without a seed: the mask comes from a
    generator made from ``seed`` on x's device, so a recomputation under
    ``torch.utils.checkpoint`` draws the same mask."""
    if seed is None or rate <= 0.0:
        return x
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


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

    def hidden_states(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        dropout: Optional[torch.Generator] = None,
        trainable: bool = False,
    ):
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        carry = torch.promote_types(dtype, torch.bfloat16)  # residual carry
        eps = cfg.layer_norm_eps
        plain = self.plain
        nh = cfg.num_attention_heads
        hd, ad = cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob
        if trainable and self.int8:
            raise ValueError("int8 towers are inference-only: a trainable tower needs float weights")
        n = len(self.layers)
        if dropout is not None:  # every seed of this forward, drawn up front
            words = [flash_attention.draw_seed(dropout) for _ in range(n)]
            hseeds = torch.randint(0, 2**62, (1 + 2 * n,), generator=dropout).tolist()
        else:
            words, hseeds = [None] * n, [None] * (1 + 2 * n)
        if trainable or dropout is not None:
            flash = flash_attention.flash_attention_plain if plain else flash_attention.flash_attention

            def attention(qkv, seed):
                return flash(qkv, attention_mask, nh, seed=seed, drop_rate=ad)
        else:
            fused = (
                fused_attention.fused_attention_qkv_plain if plain
                else fused_attention.fused_attention_qkv
            )

            def attention(qkv, seed):
                return fused(qkv, attention_mask, nh)
        ln_quant = (
            fused_ln.fused_residual_ln_quant_plain if plain
            else fused_ln.fused_residual_ln_quant
        )
        mlp_kernel = fused_mlp.fused_mlp_block_plain if plain else fused_mlp.fused_mlp_block
        # the reference's gates (encoder.py:345-368), less the TPU-only ones
        use_fused_quant = (
            cfg.use_fused_ln and carry == torch.bfloat16 and self.int8 and dropout is None
        )
        use_fused_mlp = use_fused_quant and cfg.use_fused_mlp
        remat = cfg.remat if torch.is_grad_enabled() and not self.int8 else False

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
        x = _dropout(x, hd, hseeds[0])
        gelu = "tanh" if dtype == torch.bfloat16 else "none"

        def mlp_block(x, pq, layer, seed):
            if use_fused_mlp:
                ffn, out, ln = layer.intermediate, layer.output, layer.output_layer_norm
                x, xq, xs = mlp_kernel(
                    x, pq[0], pq[1], ffn.weight, ffn.kernel_scale, ffn.bias,
                    out.weight, out.kernel_scale, out.bias, ln.weight, ln.bias,
                    eps=eps, out_dtype=carry,
                )
                return x, (xq, xs)
            inter = F.gelu(
                _dense(x, layer.intermediate, dtype, out_dtype=dtype, prequant=pq),
                approximate=gelu,
            )
            out = _dropout(_dense(inter, layer.output, dtype), hd, seed)
            return res_ln(x, out, layer.output_layer_norm)

        def layer_fn(x, pq, layer, words, s_attn, s_mlp):
            att = layer.attention
            qkv = _dense(x, att["qkv"], dtype, out_dtype=dtype, prequant=pq).contiguous()
            out = _dropout(_dense(attention(qkv, words), att["output"], dtype), hd, s_attn)
            x, pq = res_ln(x, out, att["output_layer_norm"])
            if remat == "mlp":  # float towers only: pq is None
                return checkpoint(lambda x: mlp_block(x, None, layer, s_mlp)[0], x,
                                  use_reentrant=False, preserve_rng_state=False), None
            return mlp_block(x, pq, layer, s_mlp)

        for li, layer in enumerate(self.layers):
            args = (layer, words[li], hseeds[1 + 2 * li], hseeds[2 + 2 * li])
            if remat and remat != "mlp":  # the whole layer
                x = checkpoint(lambda x, a=args: layer_fn(x, None, *a)[0], x,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x, pq = layer_fn(x, pq, *args)
        return x

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        use_mean: bool = False,
        dropout: Optional[torch.Generator] = None,
        trainable: bool = False,
    ) -> torch.Tensor:
        """encoder -> CLS (or masked-mean) pooling -> embeddingHead ->
        LayerNorm(eps 1e-5); [B, embedding_dim] float32
        (haconvdr_tpu/models/encoder.py:489-519).  ``dropout``: a
        generator turns on train-mode dropout (None: eval); ``trainable``
        marks the tower gradients flow through (flash attention)."""
        input_ids = input_ids.to(torch.int64)
        hidden = self.hidden_states(input_ids, attention_mask, dropout, trainable)
        if use_mean:
            m = attention_mask.to(torch.float32)[:, :, None]
            pooled = (hidden * m).sum(dim=1) / m.sum(dim=1)
        else:
            pooled = hidden[:, 0]
        proj = _dense(pooled, self.embedding_head, torch_dtype(self.cfg.dtype))
        return layer_norm(proj, self.norm.weight, self.norm.bias, 1e-5)
