"""Contrastive training step and host loop on a mesh of device slots
(counterpart of haconvdr_tpu/train/trainer.py).

  * a trainable query tower (``AnceEncoder`` in train mode: flash-attention
    kernels, dropout from the state's generator, the padded ``[B, L]``
    rows) and a FROZEN passage tower (eval mode, under ``torch.no_grad``;
    an inference forward, so packed to its rows' lengths by ``ops.pack``,
    planned from the batch's masks on the host), as the reference trains
    (src/train_HAConvDR_topiocqa.py:119-208);
  * AdamW with no decay on biases and LayerNorms, and the linear warmup /
    linear decay schedule, with optax's arithmetic (the JAX package's
    ``optax.chain(clip_by_global_norm, adamw)``);
  * gradient accumulation over ``accumulation_steps`` micro batches with
    sum semantics, then the global-norm clip and one update;
  * ``Trainer.fit``: the best-(micro)batch-loss ``save_fn`` and periodic
    train-state checkpoints with resume (train/checkpoint.py).

Data parallel, as JAX's one jit over the mesh (``P("dp", None)``): each
micro batch is cut over the mesh's ``dp`` slots (``batch_slices``: ceil(B
/ dp) rows a slot, a short last slice padded to that shape with copies of
the batch's first row; the ``tp`` axis replicates).  Each slot embeds its
rows on its device's replica of the two towers, with the dropout masks of
those rows in the whole batch (one ``DropoutDraw`` a micro step, the
slot's first row as the offset).  The slots' embeddings, padding rows
dropped, are gathered in slot order on the first slot (``.to`` and
``torch.cat`` carry the query tower's gradient) and the loss is computed
once there over the whole batch: JAX's loss, every query against every
positive of the batch, not a mean of per-slot losses.  After the
backward the other devices' gradients are summed into the first
replica's accumulation buffer in slot order; the clip and the update run
there, and the parameters are copied to the other replicas, which stay
bit-identical.  One slot (``make_mesh(devices=[dev])``) is the
one-device step.  There is no ``torch.distributed`` training: JAX's
trainer is one program over the mesh's devices.

The port updates the parameters, the AdamW moments and the accumulation
buffer in place (JAX returns new arrays): one copy of each lives on the
first device.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from haconvdr_torch.config import ModelConfig, TrainConfig
from haconvdr_torch.device import DeviceLike, resolve_device, to_torch
from haconvdr_torch.models.encoder import AnceEncoder, draw_dropout, quantize_encoder_params
from haconvdr_torch.parallel.mesh import Mesh, batch_slices, replicate
from haconvdr_torch.train.loss import ranking_loss, ranking_loss_prepos

logger = logging.getLogger(__name__)


def linear_warmup_decay_schedule(
    learning_rate: float, num_warmup_steps: int, num_training_steps: int
) -> Callable[[int], np.float32]:
    """transformers.get_linear_schedule_with_warmup, in float32 as the JAX
    schedule computes it; the first update uses ``schedule(0)``."""

    def schedule(step: int) -> np.float32:
        s = np.float32(step)
        if step < num_warmup_steps:
            frac = s / np.float32(max(num_warmup_steps, 1))
        else:
            denom = np.float32(max(num_training_steps - num_warmup_steps, 1))
            frac = max(np.float32(0.0), (np.float32(num_training_steps) - s) / denom)
        return np.float32(learning_rate) * np.float32(frac)

    return schedule


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Weight decay applies to dense kernels and embeddings; biases and
    LayerNorm parameters are excluded (src/utils.py:115-120)."""
    mask = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            mask[full] = not (isinstance(mod, nn.LayerNorm) or pname == "bias")
    return mask


@dataclass
class AdamWState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    decay: Dict[str, bool]  # decay_mask of the model: fixed by its structure
    count: int = 0  # updates applied (optax's adam and schedule counts)


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, 0.9,
    0.999, eps, weight_decay, mask))`` applied in place: the clip is
    ``g / ||g|| * max_norm`` when ``||g|| >= max_norm`` (optax's formula,
    not ``clip_grad_norm_``'s ``||g|| + 1e-6``), then Adam with bias
    correction and ``eps`` after the square root, plus decoupled decay on
    the masked parameters, times ``-schedule(count)``."""

    b1, b2 = 0.9, 0.999

    def __init__(self, schedule, max_grad_norm: float, eps: float, weight_decay: float):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, model: nn.Module) -> AdamWState:
        zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        return AdamWState(mu=zeros, nu={n: torch.zeros_like(p) for n, p in zeros.items()},
                          decay=decay_mask(model))

    def clip_(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Clip ``grads`` in place by their global norm; returns the norm
        (a device scalar: no host sync)."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        keep = norm < self.max_grad_norm
        div = torch.where(keep, torch.ones_like(norm), norm)
        mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, self.max_grad_norm))
        for g in grads.values():
            g.div_(div).mul_(mul)
        return norm

    def apply_(self, model: nn.Module, grads: Dict[str, torch.Tensor], state: AdamWState) -> None:
        """One update of ``model``'s parameters from ``grads`` (clipped in
        place first)."""
        self.clip_(grads)
        lr = float(self.schedule(state.count))
        state.count += 1
        bc1 = np.float32(1.0 - self.b1**state.count)
        bc2 = np.float32(1.0 - self.b2**state.count)
        with torch.no_grad():
            for name, p in model.named_parameters():
                g, mu, nu = grads[name], state.mu[name], state.nu[name]
                mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
                nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
                u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + self.eps)
                if state.decay[name] and self.weight_decay:
                    u = u + self.weight_decay * p
                p.add_(u * -lr)


def make_optimizer(cfg: TrainConfig, total_steps: int) -> ClipAdamW:
    schedule = linear_warmup_decay_schedule(
        cfg.learning_rate, int(cfg.num_warmup_portion * total_steps), total_steps
    )
    return ClipAdamW(schedule, cfg.max_grad_norm, cfg.adam_epsilon, cfg.weight_decay)


@dataclass
class TrainState:
    model: AnceEncoder  # the trainable query tower: its parameters are the params
    opt_state: AdamWState
    accum_grads: Dict[str, torch.Tensor]
    micro_step: int  # micro batches in the current accumulation window
    global_step: int  # applied updates
    rng: torch.Generator  # dropout seeds (host generator), drawn every micro step
    # one tower a distinct device of the step's mesh, ``model`` first (the
    # step makes them from ``model``); every update leaves them bit-equal
    replicas: List[AnceEncoder] = field(default_factory=list)


def distinct_replicas(mesh: Mesh, module: nn.Module) -> List[nn.Module]:
    """``module`` and one copy a distinct device of ``mesh`` after the
    first (``replicate``), in mesh order; ``module`` must live on the
    mesh's first device."""
    out: List[nn.Module] = []
    for m in replicate(mesh, module):
        if all(m is not o for o in out):
            out.append(m)
    if out[0] is not module:
        raise ValueError(f"the tower must live on the mesh's first device {mesh.first}")
    return out


def init_train_state(model: AnceEncoder, optimizer: ClipAdamW, seed: int = 42) -> TrainState:
    return TrainState(
        model=model,
        opt_state=optimizer.init(model),
        accum_grads={n: torch.zeros_like(p) for n, p in model.named_parameters()},
        micro_step=0,
        global_step=0,
        rng=torch.Generator().manual_seed(seed),
    )


def frozen_config(model_cfg: ModelConfig, train_cfg: TrainConfig) -> ModelConfig:
    """The frozen towers' config: ``frozen_dtype`` replaces the compute
    dtype; "int8" means int8 dense kernels with a bfloat16 carry (the JAX
    trainer's rule, trainer.py:123-138)."""
    fd = train_cfg.frozen_dtype
    if not fd or fd == model_cfg.dtype:
        return model_cfg
    return dataclasses.replace(model_cfg, dtype="bfloat16" if fd == "int8" else fd)


def build_frozen_encoder(
    frozen_params, model_cfg: ModelConfig, train_cfg: TrainConfig,
    device: DeviceLike = None, plain: bool = False,
) -> AnceEncoder:
    """The frozen passage tower from the JAX package's nested-dict params:
    ``frozen_config``'s dtype, int8-quantized once for ``frozen_dtype="int8"``,
    no gradients."""
    if train_cfg.frozen_dtype == "int8":
        frozen_params = quantize_encoder_params(frozen_params)
    enc = AnceEncoder.from_jax_params(
        frozen_params, frozen_config(model_cfg, train_cfg), device, plain=plain
    )
    return enc.requires_grad_(False)


def embed_batch(
    model: AnceEncoder,
    frozen: AnceEncoder,
    b: Dict[str, torch.Tensor],
    train_cfg: TrainConfig,
    loss_variant: str = "prepos",
    query_key: str = "conv_qp",
    dropout=None,
    trainable: bool = True,
    row_offset: int = 0,
    batch_rows: Optional[int] = None,
    host_masks: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """The embeddings the loss takes (the JAX trainer's ``loss_fn``,
    trainer.py:140-197): ``q`` from the query tower in train mode
    (``dropout``, ``trainable``; src/train_HAConvDR_topiocqa.py:125;
    ``row_offset`` / ``batch_rows`` place these rows in the whole batch),
    and the passages from the frozen tower in eval mode without gradients
    (":126"): ``pos``, ``neg`` ([B, D], or [B, R, D] for R negatives per
    example, folded into the batch for the tower), and for ``"prepos"``
    ``pseudo`` / ``prepos`` where the config and the batch have them.
    ``host_masks``: ``b``'s ``<field>_mask`` arrays as numpy on the host
    (``_host_masks``), from which each inference forward plans its packing
    without reading its mask back (a field left out is read once)."""
    hm = host_masks or {}
    out = {"q": model(b[query_key], b[f"{query_key}_mask"], dropout=dropout,
                      trainable=trainable, row_offset=row_offset, batch_rows=batch_rows,
                      host_mask=hm.get(f"{query_key}_mask"))}

    def passages(key):
        """The frozen tower over ``key``'s rows: [B, D], or [B, R, D] for
        R passages per example (folded into the batch for the tower)."""
        ids, host = b[key], hm.get(f"{key}_mask")
        L = ids.shape[-1]
        if host is not None:
            host = host.reshape(-1, L)
        e = frozen(ids.reshape(-1, L), b[f"{key}_mask"].reshape(-1, L), host_mask=host)
        return e.reshape(ids.shape[:-1] + (-1,))

    with torch.no_grad():
        out["pos"] = passages("pos_docs")
        out["neg"] = passages("neg_docs")
        if loss_variant == "prepos":
            if train_cfg.is_pseudo_prepos and "pseudo_prepos_docs" in b:
                out["pseudo"] = passages("pseudo_prepos_docs")
            if train_cfg.is_prepos_neg and "prepos_neg_docs" in b:
                out["prepos"] = passages("prepos_neg_docs")
    return out


def embeddings_loss(
    e: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], train_cfg: TrainConfig,
    loss_variant: str = "prepos",
) -> torch.Tensor:
    """The contrastive loss of a whole batch from its embeddings
    (``embed_batch``'s) and its per-row fields (``valid``, ``num_negs``,
    ``has_pseudo_prepos``, ``has_prepos_neg``)."""
    neg_valid = None
    if e["neg"].dim() == 3 and "num_negs" in b:
        arange = torch.arange(e["neg"].shape[1], device=e["neg"].device)
        neg_valid = arange[None, :] < b["num_negs"][:, None]
    if loss_variant == "ranking":
        return ranking_loss(e["q"], e["pos"], e["neg"], valid=b["valid"], neg_valid=neg_valid)
    return ranking_loss_prepos(
        e["q"], e["pos"], e["neg"],
        pseudo_prepos_embs=e.get("pseudo"), prepos_neg_doc_embs=e.get("prepos"),
        has_pseudo=b["has_pseudo_prepos"] if "pseudo" in e else None,
        has_prepos_neg=b["has_prepos_neg"] if "prepos" in e else None,
        alpha=train_cfg.alpha, is_pseudo_prepos=train_cfg.is_pseudo_prepos,
        is_prepos_neg=train_cfg.is_prepos_neg, valid=b["valid"],
    )


def batch_to_device(batch: Dict[str, Any], device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The array fields of a ``collate()`` dict as tensors on ``device``."""
    dev = resolve_device(device)
    return {k: to_torch(v, dev) for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}


def _host_masks(batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The ``<field>_mask`` arrays of a ``collate()`` dict that are on the
    host, as numpy (a mask already on a device is left out)."""
    out = {}
    for k, v in batch.items():
        if not k.endswith("_mask"):
            continue
        if isinstance(v, torch.Tensor):
            if v.device.type != "cpu":
                continue
            v = v.numpy()
        if isinstance(v, np.ndarray) and v.ndim >= 2:
            out[k] = v
    return out


def _slot_host_masks(masks: Dict[str, np.ndarray], a: int, e: int, per: int):
    """``_slot_rows`` of the host masks: rows a:e, padded to ``per`` rows
    with copies of the first row."""
    out = {}
    for k, v in masks.items():
        t = v[a:e]
        if e - a < per:
            t = np.concatenate([t, np.repeat(v[:1], per - (e - a), axis=0)])
        out[k] = t
    return out


def _slot_rows(b: Dict[str, torch.Tensor], a: int, e: int, per: int, dev: torch.device):
    """Rows a:e of every [B, ...] field of ``b`` on ``dev``, padded to
    ``per`` rows with copies of the batch's first row (the static slice
    shape)."""
    out = {}
    for k, v in b.items():
        if v.dim() < 2:
            continue
        t = v[a:e]
        if e - a < per:
            t = torch.cat([t, v[:1].expand((per - (e - a),) + tuple(v.shape[1:]))])
        out[k] = t.to(dev)
    return out


def make_train_step(
    mesh: Mesh,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    optimizer: ClipAdamW,
    loss_variant: str = "prepos",  # "prepos" (topiocqa) | "ranking" (qrecc)
    query_key: str = "conv_qp",
) -> Callable[[TrainState, AnceEncoder, Dict[str, Any]], tuple]:
    """Returns ``step(state, frozen, batch) -> (state, loss)``: one micro
    batch cut over ``mesh``'s dp slots (module docstring), forward and
    backward with the loss over the whole batch, gradients summed into the
    state's buffer, and every ``accumulation_steps`` micro batches one
    clipped AdamW update.  ``frozen`` comes from ``build_frozen_encoder`` on
    the mesh's first device (replicated once to the others); ``batch`` is a
    ``collate()`` dict of numpy arrays or tensors; the query field is
    ``query_key``.  ``loss`` is a device scalar on the first slot (no host
    sync: the frozen towers plan their packing from ``batch``'s masks on
    the host; masks given as device tensors would each be read back)."""
    if loss_variant not in ("prepos", "ranking"):
        raise ValueError(f"unknown loss_variant {loss_variant!r}")
    first = mesh.first
    K = train_cfg.accumulation_steps
    dropout_on = model_cfg.hidden_dropout_prob > 0 or model_cfg.attention_probs_dropout_prob > 0
    slot_devices = list(mesh.devices[:, 0])  # a dp slot's device (tp replicates)
    frozen_memo: Dict[str, Any] = {"src": None, "copies": None}

    def step(state: TrainState, frozen: AnceEncoder, batch: Dict[str, Any]):
        if len(state.replicas) != len(mesh.distinct) or state.replicas[0] is not state.model:
            state.replicas = distinct_replicas(mesh, state.model)
        if frozen_memo["src"] is not frozen:
            frozen_memo["src"], frozen_memo["copies"] = frozen, distinct_replicas(mesh, frozen)
        towers = dict(zip(mesh.distinct, zip(state.replicas, frozen_memo["copies"])))
        b = batch_to_device(batch, first)
        host = _host_masks(batch)
        B = b["valid"].shape[0]
        slices = batch_slices(B, len(slot_devices))
        per = slices[0][1] - slices[0][0]
        draw = draw_dropout(state.rng, model_cfg.num_hidden_layers) if dropout_on else None
        parts = []
        for (a, e), dev in zip(slices, slot_devices):
            if e == a:
                continue
            model, fz = towers[dev]
            emb = embed_batch(model, fz, _slot_rows(b, a, e, per, dev), train_cfg,
                              loss_variant, query_key, dropout=draw, row_offset=a, batch_rows=B,
                              host_masks=_slot_host_masks(host, a, e, per))
            parts.append({k: t[: e - a].to(first) for k, t in emb.items()})
        emb = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        loss = embeddings_loss(emb, b, train_cfg, loss_variant)
        named = [list(r.named_parameters()) for r in state.replicas]
        # a replica whose slots held no row of this batch gets no gradient
        grads = torch.autograd.grad(loss, [p for rn in named for _, p in rn], allow_unused=True)
        n = len(named[0])
        for i, (name, _) in enumerate(named[0]):  # the replicas' in slot order
            for r in range(len(named)):
                g = grads[r * n + i]
                if g is not None:
                    state.accum_grads[name].add_(g.to(first))
        state.micro_step += 1
        if state.micro_step >= K:
            optimizer.apply_(state.model, state.accum_grads, state.opt_state)
            for g in state.accum_grads.values():
                g.zero_()
            state.micro_step = 0
            state.global_step += 1
            sync_replicas(state)
        return state, loss.detach()

    return step


def sync_replicas(state: TrainState) -> None:
    """Copy the first replica's parameters to every other replica."""
    with torch.no_grad():
        src = dict(state.model.named_parameters())
        for r in state.replicas[1:]:
            for name, p in r.named_parameters():
                p.copy_(src[name])


@dataclass
class Trainer:
    """Host loop: epochs x shuffled batches -> ``make_train_step``; the
    best-loss ``save_fn`` and the periodic train-state checkpoints
    (``state_ckpt_dir`` every ``state_ckpt_every`` micro steps, ``resume``)
    as in the JAX package (trainer.py:253-347).  A step trains
    ``per_device_train_batch_size`` x ``mesh.size`` rows, every slot of
    the mesh counted, ``tp`` included, as JAX counts every device
    (trainer.py:277-281); one slot (``make_mesh(devices=[dev])``) is one
    device.  ``metrics`` (``utils.telemetry.MetricsLogger``) gets one
    ``train_step`` event (epoch, micro step, loss) after each micro step."""

    mesh: Mesh
    model_cfg: ModelConfig
    train_cfg: TrainConfig
    loss_variant: str = "prepos"
    query_key: str = "conv_qp"
    save_fn: Optional[Callable[[AnceEncoder, int], None]] = None
    state_ckpt_dir: str = ""
    state_ckpt_every: int = 0
    resume: bool = False
    metrics: Any = None  # utils.telemetry.MetricsLogger

    def fit(self, params, frozen_params, examples, collate_batches=None):
        """Train from the JAX package's nested-dict ``params`` (the query
        tower) against ``frozen_params`` (the passage tower): returns
        (state, best micro-batch loss)."""
        from haconvdr_torch.data.loader import batch_iter, num_batches
        from haconvdr_torch.train.checkpoint import (
            latest_step,
            restore_train_state,
            save_train_state,
        )

        cfg = self.train_cfg
        dev = self.mesh.first
        batch_size = cfg.per_device_train_batch_size * max(1, self.mesh.size)
        total_steps = cfg.num_train_epochs * num_batches(len(examples), batch_size)
        optimizer = make_optimizer(cfg, max(1, total_steps // cfg.accumulation_steps))
        step_fn = make_train_step(
            self.mesh, self.model_cfg, cfg, optimizer,
            loss_variant=self.loss_variant, query_key=self.query_key,
        )
        model = AnceEncoder.from_jax_params(params, self.model_cfg, dev)
        state = init_train_state(model, optimizer, seed=cfg.seed)
        if self.resume and self.state_ckpt_dir:
            step_no = latest_step(self.state_ckpt_dir)
            if step_no is not None:
                state = restore_train_state(self.state_ckpt_dir, state, step_no)
                logger.info("resumed train state from step %d", step_no)
        frozen = build_frozen_encoder(frozen_params, self.model_cfg, cfg, dev)

        best_loss = math.inf
        global_micro = 0
        total_loss = 0.0
        t0 = time.time()
        for epoch in range(cfg.num_train_epochs):
            if callable(collate_batches):
                it = collate_batches(epoch)
            elif collate_batches is not None:
                it = iter(collate_batches)  # single-epoch custom batches
            else:
                it = batch_iter(examples, batch_size, shuffle=True, seed=cfg.seed + epoch)
            for batch in it:
                state, loss = step_fn(state, frozen, batch)
                loss = float(loss)
                total_loss += loss
                global_micro += 1
                if cfg.print_steps > 0 and global_micro % cfg.print_steps == 0:
                    logger.info(
                        "epoch %d step %d loss %.5f total %.2f (%.1fs)",
                        epoch + 1, global_micro, loss, total_loss, time.time() - t0,
                    )
                if self.metrics is not None:
                    self.metrics.log(
                        "train_step", epoch=epoch + 1, micro_step=global_micro, loss=loss,
                    )
                if loss < best_loss:  # per-batch best, ":206-208"
                    best_loss = loss
                    if self.save_fn is not None:
                        self.save_fn(state.model, global_micro)
                if (
                    self.state_ckpt_dir
                    and self.state_ckpt_every > 0
                    and global_micro % self.state_ckpt_every == 0
                ):
                    save_train_state(self.state_ckpt_dir, global_micro, state)
        return state, best_loss
