"""Runs the encoder over collated batches, on one device or over a mesh
(counterpart of haconvdr_tpu/parallel/sharded_encode.py:
encoder_param_pspecs, shard_params, make_sharded_encode_fn and
encode_batches).

Batches come from ``haconvdr_torch.data.loader`` (``batch_iter`` /
``collate(pad_to=...)``, re-exported here): fixed-size int32 arrays plus
a ``valid`` row mask; padded rows are dropped from the output.

On a mesh each batch is cut over the ``dp`` slots as GSPMD shards
``P("dp", None)``: ``ceil(B / dp)`` rows a slot (a short last slice is
padded to that shape with copies of the batch's first row).  Each dp row
of the mesh runs its slice and the outputs are concatenated in slot order
on the first slot's device.  With replicated params (a module, or
``shard_params(tp=False)``) every tp slot of a dp row holds the same
replica and one of them runs; with split params (``shard_params(tp=True)``:
Megatron column and row splits, ``encoder_param_pspecs``) the tp slots of
the row run their slices together (``models.encoder.encode_split``).  A
slice of padding rows only is not run.  A row's embedding is therefore
the one it gets in a batch of ``ceil(B / dp)`` rows: it depends on the
batch shape, not on the other rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from haconvdr_torch.config import ModelConfig
from haconvdr_torch.data.loader import batch_iter
from haconvdr_torch.device import to_numpy, to_torch
from haconvdr_torch.models.convert import encoder_param_pspecs, tp_slice
from haconvdr_torch.parallel.mesh import Mesh, batch_slices, replicate
from haconvdr_torch.utils.telemetry import TRACER

__all__ = ["batch_iter", "dp_encode_fn", "encode_batches", "encoder_param_pspecs",
           "shard_params"]

EncodeFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _device_of(fn) -> Optional[torch.device]:
    return next(fn.parameters()).device if isinstance(fn, torch.nn.Module) else None


def shard_params(
    mesh: Mesh, params, tp: bool = False, *, cfg: ModelConfig,
) -> List[torch.nn.Module]:
    """One ``AnceEncoder`` a slot of ``mesh``, in slot order, from the JAX
    package's nested-dict ``params`` (int8 towers: quantize first).
    ``tp=False`` replicates the tower (one module a distinct device);
    ``tp=True`` gives slot (i, j) rank j's Megatron slices
    (``encoder_param_pspecs``; one module a distinct (device, rank)), which
    ``dp_encode_fn`` runs as a group per dp row.  ``tp`` must divide the
    heads and the intermediate width (``ValueError``)."""
    from haconvdr_torch.models.encoder import AnceEncoder, check_tp

    if not tp:
        return replicate(mesh, AnceEncoder.from_jax_params(params, cfg, mesh.first))
    T = mesh.shape["tp"]
    check_tp(cfg, T)
    built: Dict[Tuple[torch.device, int], torch.nn.Module] = {}
    out = []
    for (_, j), dev in np.ndenumerate(mesh.devices):
        if (dev, j) not in built:
            built[dev, j] = AnceEncoder.from_jax_params(tp_slice(params, j, T), cfg, dev, tp=T)
        out.append(built[dev, j])
    return out


def dp_encode_fn(
    mesh: Mesh, encoder_or_fn: Union[EncodeFn, Sequence[EncodeFn]]
) -> Callable[..., torch.Tensor]:
    """``fn(ids, mask, valid=None) -> [B, ...]`` embeddings on the mesh's
    first device, the batch cut over the ``dp`` slots.  ``encoder_or_fn``
    is a module (replicated once to every distinct device of the mesh), a
    list of one encoder a slot (``replicate``'s or ``shard_params``'), or
    a callable that runs on whichever device its inputs are on.  A dp row
    runs its first slot's encoder, or, when the slots hold the slices of a
    split tower, the row's group.  ``valid`` ([B] bool, host) skips the
    slices that hold no valid row; their rows come back as zeros."""
    if isinstance(encoder_or_fn, torch.nn.Module):
        per_slot = replicate(mesh, encoder_or_fn)
    elif isinstance(encoder_or_fn, (list, tuple)):
        per_slot = list(encoder_or_fn)
    else:
        per_slot = [encoder_or_fn] * mesh.size
    devices = list(mesh.devices[:, 0])
    T = mesh.shape["tp"]
    encoders = [_row_runner(per_slot[i * T : (i + 1) * T]) for i in range(len(devices))]

    def fn(ids: torch.Tensor, mask: torch.Tensor, valid=None) -> torch.Tensor:
        B = ids.shape[0]
        slices = batch_slices(B, len(devices))
        per = slices[0][1] - slices[0][0]
        outs: List[Tuple[int, int, torch.Tensor]] = []
        for (a, b), dev, enc in zip(slices, devices, encoders):
            if b == a or (valid is not None and not np.asarray(valid[a:b]).any()):
                continue
            x, m = ids[a:b], mask[a:b]
            if b - a < per:  # the batch's static slice shape
                fill = per - (b - a)
                x = torch.cat([x, ids[:1].expand(fill, -1)])
                m = torch.cat([m, mask[:1].expand(fill, -1)])
            outs.append((a, b, enc(x.to(dev), m.to(dev))))
        first = mesh.first
        head = outs[0][2]
        out = torch.zeros((B,) + tuple(head.shape[1:]), dtype=head.dtype, device=first)
        for a, b, e in outs:
            out[a:b] = e[: b - a].to(first)
        return out

    return fn


def _row_runner(group: List[EncodeFn]) -> EncodeFn:
    """What a dp row runs: its tp group of a split tower's slices together,
    else its first slot's encoder."""
    if getattr(group[0], "tp", 1) > 1:
        from haconvdr_torch.models.encoder import encode_split

        return lambda x, m: encode_split(group, x, m)
    return group[0]


def encode_batches(
    encoder_or_fn: Union[torch.nn.Module, EncodeFn, Sequence[EncodeFn]],
    batches: Iterable[dict],
    key_ids: str,
    key_mask: str,
    mesh: Optional[Mesh] = None,
) -> Tuple[np.ndarray, List]:
    """(embeddings [n_valid, E] float32 numpy, sample ids) over the
    batches: on the encoder's device, or with a ``mesh`` cut over its dp
    slots (:func:`dp_encode_fn`)."""
    if mesh is not None:
        fn = dp_encode_fn(mesh, encoder_or_fn)
        device = mesh.first
    else:
        fn = encoder_or_fn
        device = _device_of(encoder_or_fn)
    embs, ids = [], []
    batches = iter(batches)
    with torch.inference_mode():
        while True:
            with TRACER.span("tower.collate"):  # a lazy iterator collates here
                batch = next(batches, None)
            if batch is None:
                break
            valid = np.asarray(batch["valid"]).astype(bool)
            with TRACER.span("tower.h2d"):
                x = to_torch(batch[key_ids], device)
                m = to_torch(batch[key_mask], device)
            with TRACER.span("tower.launch"):
                e = fn(x, m, valid) if mesh is not None else fn(x, m)
            with TRACER.span("tower.wait"):
                e = to_numpy(e)
            embs.append(e[valid])
            ids.extend(s for s, v in zip(batch["sample_id"], valid) if v)
    return np.concatenate(embs, axis=0), ids
