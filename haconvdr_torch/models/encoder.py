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

Inference forwards run packed (``ops.pack``): the plan, made on the host
from the mask (``host_mask=``, else read from the mask tensor), keeps each
row's span up to its last valid token.  The embeddings, every dense, the
GELU, the LayerNorms and the int8 codes run on those ``T`` rows only
(``[T, H]``); each layer scatters its packed QKV rows into a ``[B, L']``
buffer (``L'`` the longest span rounded up to 16; zeroed once a forward,
so its pad positions stay finite), runs the same attention kernel there
and gathers the context rows back.  CLS pooling reads each row's first
packed row.  Every step is per token or per row, so an int8 tower gives the
padded layout's result bit for bit; a float tower's denses round over
another row count.  Train-mode forwards keep the padded ``[B, L]`` rows.

int8 towers (``quantize_encoder_params``): the transformer layers' dense
kernels are int8 per output channel (``Int8Linear``), activations are
quantized per token, dynamically, and multiplied with exact int32
accumulation (``ops.int8_dense``: on CUDA one kernel for the codes and one
for the product with its dequantization, bias and cast).  With a bfloat16
carry the tower routes as the reference's
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
parity tests run with dropout off.  A data-parallel slot that holds rows
a.. of a batch of n (``forward(..., row_offset=a, batch_rows=n)``, with one
``DropoutDraw`` shared by the slots) draws those rows' masks of the whole
batch: the attention hash takes the row offset, and each hidden site draws
all n rows' uniforms and keeps its own (``_dropout`` states the cost).

Tensor parallelism (``tp`` > 1, inference only): a rank's ``AnceEncoder``
holds its Megatron slices (``AnceLayer``; ``convert.tp_slice``), and
``encode_split`` runs a group of ranks layer by layer: embeddings,
LayerNorms and the head on the first rank, the column denses and
attention (``num_attention_heads / tp`` heads) on every rank, the row
denses summed on the first rank (``parallel.mesh.group_sum``, in rank
order) with the bias added once.  int8 towers stay exact: each row-split
dense's codes take the group's row maximum and its int32 partials are
summed before the dequantization (``_row_dense``; the MLP block through
row 10's split pieces, ``mlp_block_split``), so a split int8 tower equals the
un-split one bit for bit.  Float towers sum float32 partials, a rounding
the un-split tower does not make.
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
from haconvdr_torch.ops import (
    flash_attention, fused_attention, fused_ln, fused_mlp, int8_dense, pack,
)
from haconvdr_torch.ops.fused_ln import layer_norm
from haconvdr_torch.parallel.mesh import group_max, group_sum


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
    per-output-channel ``kernel_scale`` and ``bias`` float32 [out].  CUDA
    tensors take ``ops.int8_dense``'s kernels, CPU tensors and ``plain``
    its plain twin."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.zeros(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    def forward(self, x: torch.Tensor, prequant=None, out_dtype=None,
                plain: bool = False) -> torch.Tensor:
        """float32 (or ``out_dtype``) ``x @ W^T``; ``prequant=(xq, xs)``
        skips the dynamic per-token quantization of x."""
        dense = int8_dense.int8_dense_plain if plain else int8_dense.int8_dense
        return dense(x, self.weight, self.kernel_scale, self.bias, prequant, out_dtype)


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


def _matmul(x, lin, dtype):
    """``x @ W^T`` of a float dense without its bias: the ``dtype``-rounded
    operands, accumulated in promote(dtype, f32).  bfloat16 on CUDA is one
    bf16 GEMM with a float32 result (``_MmF32``); elsewhere a float32
    product of the rounded operands (exact products, float32 sums; TF32 is
    off, device.py)."""
    acc = torch.promote_types(dtype, torch.float32)
    w = lin.weight.to(dtype)
    if dtype == torch.bfloat16 and x.is_cuda:
        y = _MmF32.apply(x.reshape(-1, x.shape[-1]).to(dtype), w)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.to(dtype).to(acc), w.to(acc))


def _dense(x, lin, dtype, out_dtype=None, prequant=None, plain=False):
    """One dense layer.  int8: ``Int8Linear`` (``plain``: its twin).  float:
    ``_matmul`` plus the bias in promote(dtype, f32), rounded once to
    ``out_dtype``."""
    if isinstance(lin, Int8Linear):
        return lin(x, prequant, out_dtype, plain)
    y = _matmul(x, lin, dtype) + lin.bias.to(torch.promote_types(dtype, torch.float32))
    return y if out_dtype is None else y.to(out_dtype)


def _row_dense(xs, lins, dtype, out_dtype=None, plain=False):
    """A row-split dense over a tp group: rank r multiplies its input
    columns ``xs[r]`` by its rows of W (``lins[r]``), the partial products
    are summed on the first rank (``group_sum``, in rank order) and the
    bias, replicated, is added once after the sum.  int8: every rank codes
    its columns with the whole row's scale (the group's maximum of the
    ranks' row maxima, exact) and the int32 partials are summed before the
    dequantization, so the result equals the un-split dense bit for bit.
    float: the float32 partials are summed, a rounding the un-split dense
    does not make.  One rank is ``_dense``.  The result is float32 (or
    ``out_dtype``, rounded once)."""
    if len(lins) == 1:
        return _dense(xs[0], lins[0], dtype, out_dtype, plain=plain)
    lin0 = lins[0]
    first = xs[0].device
    if isinstance(lin0, Int8Linear):
        amax = group_max([x.to(torch.float32).abs().amax(dim=-1, keepdim=True) for x in xs])
        scale = torch.clamp_min(amax, 1e-30)
        parts = []
        for x, lin in zip(xs, lins):
            xq, _ = quantize_rows(x, scale.to(x.device))
            parts.append(fused_mlp._int_mm(xq.reshape(-1, x.shape[-1]), lin.weight))
        y = fused_mlp.dequant_int32(group_sum(parts), scale, lin0.kernel_scale, lin0.bias)
        y = y.reshape(*xs[0].shape[:-1], lin0.weight.shape[0])
    else:
        y = group_sum([_matmul(x, lin, dtype) for x, lin in zip(xs, lins)])
        y = y + lin0.bias.to(torch.promote_types(dtype, torch.float32)).to(first)
    return y if out_dtype is None else y.to(out_dtype)


def mlp_block_split(x, xq, xs, w1s, s1s, b1s, w2s, w2_scale, b2, ln_scale, ln_bias,
                    eps=1e-12, out_dtype=None, plain=False):
    """``fused_mlp.fused_mlp_block`` over a tp group (row 10's split mode):
    ``w1s`` [I/tp, H] (with ``s1s``, ``b1s``) and ``w2s`` [H, I/tp] one a
    rank, in rank order, each on its rank's device; ``x``, ``xq``, ``xs``,
    W2's scale and bias and the LayerNorm on the first rank's device, where
    ``(y, yq, ys)`` come back.  Every rank runs ``split_up``; the group's
    row maximum of |g| (``group_max``, exact) goes back to every rank,
    which codes its g with it and writes its int32 partial products
    (``split_down``) into one [tp, rows, H] buffer on the first rank; there
    ``split_finish`` sums them in int32 before the dequantization, so the
    result equals the un-split block bit for bit.  Each piece launches its
    kernels on CUDA tensors; ``plain`` takes the twins on any device."""
    pre = "_plain" if plain else ""
    up, down, finish = (getattr(fused_mlp, f"split_{k}{pre}") for k in ("up", "down", "finish"))
    if sum(w.shape[0] for w in w1s) > fused_mlp.MAX_I:
        raise ValueError(f"the split block's whole I must be <= {fused_mlp.MAX_I} "
                         "(exact int32 sums)")
    first = x.device
    ups = [up(xq.to(w1.device), xs.to(w1.device), w1, s1, b1) for w1, s1, b1 in zip(w1s, s1s, b1s)]
    gmax = group_max([gm for _, gm in ups])  # the global g scale, on the first rank
    H = x.shape[-1]
    part = torch.empty((len(w1s), x.numel() // H, H), dtype=torch.int32, device=first)
    gss = []  # every rank's codes take the same scale
    for r, ((g, _), w2) in enumerate(zip(ups, w2s)):
        if w2.device == first:  # written in place; another device's partial comes over
            gss.append(down(g, gmax, w2, out=part[r])[1])
        else:
            p_r, gs_r = down(g, gmax.to(w2.device), w2)
            part[r].copy_(p_r)
            gss.append(gs_r)
    return finish(part, gss[0].to(first), x, w2_scale, b2, ln_scale, ln_bias, eps, out_dtype)


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int], rows=None) -> torch.Tensor:
    """Inverted dropout, a no-op without a seed: the mask comes from a
    generator made from ``seed`` on x's device, so a recomputation under
    ``torch.utils.checkpoint`` draws the same mask.  ``rows = (a, n)``: x
    holds rows a.. of a batch of n rows (a data-parallel slot), and its
    mask is rows a.. of the mask drawn for the whole batch: each slot draws
    all n rows' uniforms and keeps its own, so a mesh of dp slots draws dp
    times the one-device step's uniforms (n x L x H floats a site, each
    slot).  Rows past the batch's end (shape padding) are kept."""
    if seed is None or rate <= 0.0:
        return x
    g = torch.Generator(device=x.device).manual_seed(seed)
    a, n = rows if rows is not None else (0, x.shape[0])
    u = torch.rand((n,) + tuple(x.shape[1:]), generator=g, device=x.device)[a : a + x.shape[0]]
    if u.shape[0] < x.shape[0]:
        u = torch.cat([u, u.new_zeros((x.shape[0] - u.shape[0],) + tuple(x.shape[1:]))])
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


@dataclasses.dataclass(frozen=True)
class DropoutDraw:
    """The seeds of one train-mode forward, drawn up front: each layer's
    two attention seed words and the ``1 + 2 x layers`` hidden-dropout
    seeds.  The data-parallel train step draws one and hands it to every
    slot's forward."""

    words: tuple
    hseeds: tuple


def draw_dropout(generator: torch.Generator, n_layers: int) -> DropoutDraw:
    """Every seed of one forward, from ``generator`` (in the order a
    forward given the generator draws them)."""
    words = tuple(flash_attention.draw_seed(generator) for _ in range(n_layers))
    hseeds = torch.randint(0, 2**62, (1 + 2 * n_layers,), generator=generator).tolist()
    return DropoutDraw(words, tuple(hseeds))


class AnceLayer(nn.Module):
    """One transformer layer; with ``tp`` > 1 one rank's Megatron slice:
    the fused QKV and FFN-up column-split (``nh / tp`` heads: the rank's
    ``[q_r | k_r | v_r]``), the attention output and FFN-down row-split."""

    def __init__(self, cfg: ModelConfig, int8: bool = False, tp: int = 1):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        linear = Int8Linear if int8 else nn.Linear
        self.attention = nn.ModuleDict(
            {
                "qkv": linear(H, 3 * H // tp),  # [q | k | v] kernels (and scales), fused
                "output": linear(H // tp, H),
                "output_layer_norm": nn.LayerNorm(H),
            }
        )
        self.intermediate = linear(H, I // tp)
        self.output = linear(I // tp, H)
        self.output_layer_norm = nn.LayerNorm(H)


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """A tower splits over ``tp`` ranks only where ``tp`` divides the heads
    and the intermediate width (JAX's GSPMD would reshard instead)."""
    if tp < 1 or cfg.num_attention_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(
            f"tp={tp} must divide num_attention_heads ({cfg.num_attention_heads}) and "
            f"intermediate_size ({cfg.intermediate_size})"
        )


class AnceEncoder(nn.Module):
    """RoBERTa/BERT transformer + ANCE ``embeddingHead`` + LayerNorm.

    ``forward(input_ids, attention_mask)`` -> [B, embedding_dim] float32.
    ``int8`` builds the int8 tower (``from_jax_params`` decides it from the
    params).  ``plain=True`` runs every kernel's plain twin on any device
    (the reference a kernel run is held against); the default dispatches
    on the tensors' device.  ``tp`` > 1 makes one rank's slice of a
    tensor-parallel tower (``AnceLayer``), which runs with the rest of its
    group through ``encode_split``.
    """

    def __init__(self, cfg: ModelConfig, int8: bool = False, plain: bool = False, tp: int = 1):
        super().__init__()
        check_tp(cfg, tp)
        self.cfg = cfg
        self.int8 = int8
        self.plain = plain
        self.tp = tp
        H = cfg.hidden_size
        self.embeddings = nn.ModuleDict(
            {
                "word_embeddings": nn.Embedding(cfg.vocab_size, H),
                "position_embeddings": nn.Embedding(cfg.max_position_embeddings, H),
                "token_type_embeddings": nn.Embedding(cfg.type_vocab_size, H),
                "layer_norm": nn.LayerNorm(H),
            }
        )
        self.layers = nn.ModuleList(
            AnceLayer(cfg, int8, tp) for _ in range(cfg.num_hidden_layers)
        )
        self.embedding_head = nn.Linear(H, cfg.embedding_dim)
        self.norm = nn.LayerNorm(cfg.embedding_dim)

    @classmethod
    def from_jax_params(
        cls, params, cfg: ModelConfig, device: DeviceLike = None, plain: bool = False,
        tp: int = 1,
    ) -> "AnceEncoder":
        """Build from the JAX package's nested-dict params (numpy leaves,
        float or int8-quantized) without a throwaway random init.  The
        embedding width is the head's, as in the JAX ``encode`` (an HF
        ``config.json`` does not record it: ``config_from_hf``).  With
        ``tp`` > 1 the params are one rank's slices
        (``convert.tp_slice``)."""
        sd = params_from_jax(params)
        emb_dim = sd["embedding_head.weight"].shape[0]
        if emb_dim != cfg.embedding_dim:
            cfg = dataclasses.replace(cfg, embedding_dim=emb_dim)
        with torch.device("meta"):
            enc = cls(cfg, int8="layers.0.attention.qkv.kernel_scale" in sd, plain=plain, tp=tp)
        enc.load_state_dict(sd, assign=True)
        return enc.to(resolve_device(device)).eval()

    @property
    def device(self) -> torch.device:
        return self.embeddings["word_embeddings"].weight.device

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        use_mean: bool = False,
        dropout=None,
        trainable: bool = False,
        row_offset: int = 0,
        batch_rows: Optional[int] = None,
        host_mask=None,
    ) -> torch.Tensor:
        """encoder -> CLS (or masked-mean) pooling -> embeddingHead ->
        LayerNorm(eps 1e-5); [B, embedding_dim] float32
        (haconvdr_tpu/models/encoder.py:489-519).  ``dropout``: a
        generator (or a ``DropoutDraw``) turns on train-mode dropout (None:
        eval); ``trainable`` marks the tower gradients flow through (flash
        attention).  ``row_offset`` / ``batch_rows``: these rows are rows
        ``row_offset..`` of a batch of ``batch_rows`` (a data-parallel
        slot's slice; default the whole batch), and every dropout mask is
        those rows' mask of the whole batch.  ``host_mask``: the mask as
        numpy on the host, from which an inference forward plans its
        packing (``ops.pack``; without it the forward reads the mask)."""
        rows = (row_offset, row_offset + input_ids.shape[0] if batch_rows is None else batch_rows)
        return encode_split([self], input_ids, attention_mask, use_mean, dropout, trainable,
                            rows, host_mask)


def encode_split(
    towers, input_ids: torch.Tensor, attention_mask: torch.Tensor, use_mean: bool = False,
    dropout=None, trainable: bool = False, rows=None, host_mask=None,
) -> torch.Tensor:
    """The tower's forward over a tp group: ``towers`` holds one
    ``AnceEncoder`` a rank (``tp`` each, in rank order, each on its
    rank's device; one tower is ``AnceEncoder.forward``).  The embeddings,
    LayerNorms and the head run on the first rank; each layer's column
    denses and attention run on every rank on its slice and the row denses
    meet on the first rank (``_row_dense``, ``mlp_block_split``).
    An inference forward packs the batch (``ops.pack``, planned from
    ``host_mask`` or the mask); a train-mode one (``dropout`` or
    ``trainable``) runs the padded ``[B, L]`` rows.
    Returns [B, embedding_dim] float32 on the first rank's device."""
    if len(towers) != towers[0].tp:
        raise ValueError(f"a group of {len(towers)} towers split {towers[0].tp} ways")
    plan = None
    if dropout is None and not trainable:
        plan = pack.plan_of(attention_mask, host_mask)
    return _encode(towers, input_ids, attention_mask, use_mean, dropout, trainable, rows, plan)


def _encode(towers, input_ids, attention_mask, use_mean=False, dropout=None, trainable=False,
            rows=None, plan=None):
    """``encode_split`` in the layout ``plan`` gives: packed (a
    ``pack.Plan``), or the padded rows (None)."""
    t0 = towers[0]
    dev = t0.device
    input_ids = input_ids.to(torch.int64).to(dev)
    attention_mask = attention_mask.to(dev)
    kept = starts = None
    if plan is not None:
        input_ids = input_ids[:, : plan.width]
        attention_mask = attention_mask[:, : plan.width].to(torch.int32).contiguous()
        kept, starts = plan.to(dev)
    hidden = _hidden_states(towers, input_ids, attention_mask, dropout, trainable, rows, kept)
    if use_mean:
        m = attention_mask.to(torch.float32)[:, :, None]
        if kept is not None:  # the packed rows back in [B, width], zero elsewhere
            full = hidden.new_zeros((m.shape[0] * m.shape[1], hidden.shape[-1]))
            hidden = pack.scatter(full, kept, hidden).view(m.shape[0], m.shape[1], -1)
        pooled = (hidden * m).sum(dim=1) / m.sum(dim=1)
    elif kept is not None:
        pooled = hidden.index_select(0, starts)
    else:
        pooled = hidden[:, 0]
    proj = _dense(pooled, t0.embedding_head, torch_dtype(t0.cfg.dtype))
    return layer_norm(proj, t0.norm.weight, t0.norm.bias, 1e-5)


def _hidden_states(towers, input_ids, attention_mask, dropout=None, trainable=False, rows=None,
                   kept=None):
    """The transformer over a tp group of towers (one tower: the un-split
    forward); ids and mask on the first tower's device.  ``kept``: the
    packed layout's positions in ``[B, L]`` (``pack.Plan.to``), whose rows
    the token-wise layers run ([T, H] out); None: every position ([B, L,
    H] out)."""
    t0 = towers[0]
    cfg = t0.cfg
    T = len(towers)
    dtype = torch_dtype(cfg.dtype)
    carry = torch.promote_types(dtype, torch.bfloat16)  # residual carry
    eps = cfg.layer_norm_eps
    plain = t0.plain
    nh = cfg.num_attention_heads // T
    hd, ad = cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob
    if trainable and t0.int8:
        raise ValueError("int8 towers are inference-only: a trainable tower needs float weights")
    if T > 1 and (trainable or dropout is not None):
        raise ValueError("a tensor-parallel tower is inference-only: train on a dp mesh")
    n = cfg.num_hidden_layers
    if isinstance(dropout, torch.Generator):  # every seed of this forward, drawn up front
        dropout = draw_dropout(dropout, n)
    if dropout is not None:
        words, hseeds = dropout.words, dropout.hseeds
    else:
        words, hseeds = [None] * n, [None] * (1 + 2 * n)
    row_offset = 0 if rows is None else rows[0]
    devs = [t.device for t in towers]
    masks = [attention_mask.to(d) for d in devs]

    def bcast(t):
        """``t`` on every rank's device (no copy where it already is)."""
        return [t.to(d) for d in devs]

    if trainable or dropout is not None:
        flash = flash_attention.flash_attention_plain if plain else flash_attention.flash_attention

        def attention(qkv, r, seed):
            return flash(qkv, masks[r], nh, seed=seed, drop_rate=ad, row_offset=row_offset)
    else:
        fused = (
            fused_attention.fused_attention_qkv_plain if plain
            else fused_attention.fused_attention_qkv
        )

        if kept is None:
            def attention(qkv, r, seed):
                return fused(qkv, masks[r], nh)
        else:  # packed rows in, through a [B, L] buffer, context rows out
            B, L = input_ids.shape
            kepts = bcast(kept)
            bufs = [None] * T  # each rank's [B * L, 3H / tp], zeroed once: finite pads

            def attention(qkv, r, seed):
                if bufs[r] is None:
                    bufs[r] = qkv.new_zeros((B * L, qkv.shape[-1]))
                buf = pack.scatter(bufs[r], kepts[r], qkv).view(B, L, -1)
                return pack.gather(fused(buf, masks[r], nh), kepts[r])
    ln_quant = (
        fused_ln.fused_residual_ln_quant_plain if plain
        else fused_ln.fused_residual_ln_quant
    )
    if T == 1:
        mlp_kernel = fused_mlp.fused_mlp_block_plain if plain else fused_mlp.fused_mlp_block
    else:
        def mlp_kernel(*args, **kw):
            return mlp_block_split(*args, **kw, plain=plain)
    # the reference's gates (encoder.py:345-368), less the TPU-only ones
    use_fused_quant = (
        cfg.use_fused_ln and carry == torch.bfloat16 and t0.int8 and dropout is None
    )
    use_fused_mlp = use_fused_quant and cfg.use_fused_mlp
    remat = cfg.remat if torch.is_grad_enabled() and not t0.int8 else False

    def branch_dtype(seed):
        """A row dense's output type: the carry where no dropout follows
        (res_ln casts to it before the add, so rounding there is the same),
        else float32."""
        return carry if seed is None else None

    def res_ln(x, branch_out, ln):
        """(LayerNorm(x + branch_out), prequant) in the carry dtype; the
        branch output is cast to the carry before the add."""
        if use_fused_quant:
            y, yq, ys = ln_quant(
                x, branch_out.to(x.dtype), ln.weight, ln.bias, eps, out_dtype=carry
            )
            return y, (yq, ys)
        return layer_norm(x + branch_out.to(x.dtype), ln.weight, ln.bias, eps, carry), None

    def col_inputs(x, pq):
        """x and its prequantization on every rank."""
        pqs = [None] * T if pq is None else list(zip(bcast(pq[0]), bcast(pq[1])))
        return bcast(x), pqs

    emb = t0.embeddings
    if cfg.model_type.upper().startswith("BERT"):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    else:
        pos = roberta_position_ids(input_ids, cfg.pad_token_id)
    if kept is not None:  # over the padded row (the pads count), then packed
        pos = pack.gather(pos.expand_as(input_ids), kept)
        input_ids = pack.gather(input_ids, kept)
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
    x = _dropout(x, hd, hseeds[0], rows)
    gelu = "tanh" if dtype == torch.bfloat16 else "none"

    def mlp_block(x, pq, lyrs, seed):
        out, ln = lyrs[0].output, lyrs[0].output_layer_norm
        if use_fused_mlp:
            if T == 1:
                ffn = lyrs[0].intermediate
                w1, s1, b1, w2 = ffn.weight, ffn.kernel_scale, ffn.bias, out.weight
            else:
                w1 = [l.intermediate.weight for l in lyrs]
                s1 = [l.intermediate.kernel_scale for l in lyrs]
                b1 = [l.intermediate.bias for l in lyrs]
                w2 = [l.output.weight for l in lyrs]
            x, xq, xs = mlp_kernel(
                x, pq[0], pq[1], w1, s1, b1, w2, out.kernel_scale, out.bias, ln.weight, ln.bias,
                eps=eps, out_dtype=carry,
            )
            return x, (xq, xs)
        xr, pqs = col_inputs(x, pq)
        inter = [
            F.gelu(_dense(xi, l.intermediate, dtype, out_dtype=dtype, prequant=pi, plain=plain),
                   approximate=gelu)
            for xi, pi, l in zip(xr, pqs, lyrs)
        ]
        out = _row_dense(inter, [l.output for l in lyrs], dtype, branch_dtype(seed), plain)
        return res_ln(x, _dropout(out, hd, seed, rows), ln)

    def layer_fn(x, pq, lyrs, words, s_attn, s_mlp):
        xr, pqs = col_inputs(x, pq)
        ctx = []
        for r, (xi, pi, l) in enumerate(zip(xr, pqs, lyrs)):
            qkv = _dense(xi, l.attention["qkv"], dtype, out_dtype=dtype, prequant=pi,
                         plain=plain).contiguous()
            ctx.append(attention(qkv, r, words))
        out = _row_dense(ctx, [l.attention["output"] for l in lyrs], dtype, branch_dtype(s_attn),
                         plain)
        out = _dropout(out, hd, s_attn, rows)
        x, pq = res_ln(x, out, lyrs[0].attention["output_layer_norm"])
        if remat == "mlp":  # float towers only: pq is None
            return checkpoint(lambda x: mlp_block(x, None, lyrs, s_mlp)[0], x,
                              use_reentrant=False, preserve_rng_state=False), None
        return mlp_block(x, pq, lyrs, s_mlp)

    for li in range(n):
        args = ([t.layers[li] for t in towers], words[li], hseeds[1 + 2 * li],
                hseeds[2 + 2 * li])
        if remat and remat != "mlp":  # the whole layer
            x = checkpoint(lambda x, a=args: layer_fn(x, None, *a)[0], x,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x, pq = layer_fn(x, pq, *args)
    return x

