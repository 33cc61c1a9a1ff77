"""Runs the encoder over collated batches, on one device or data-parallel
over a mesh (counterpart of haconvdr_tpu/parallel/sharded_encode.py:
make_sharded_encode_fn with ``tp=False``, and encode_batches).

Batches come from ``haconvdr_torch.data.loader`` (``batch_iter`` /
``collate(pad_to=...)``, re-exported here): fixed-size int32 arrays plus
a ``valid`` row mask; padded rows are dropped from the output.

On a mesh each batch is cut over the ``dp`` slots as GSPMD shards
``P("dp", None)``: ``ceil(B / dp)`` rows a slot (a short last slice is
padded to that shape with copies of the batch's first row).  Each slot
runs its slice on its own device's replica of the encoder, a slice of
padding rows only is not run, and the outputs are concatenated in slot
order on the first slot's device.  A row's embedding is therefore the
one it gets in a batch of ``ceil(B / dp)`` rows on one device: it depends
on the batch shape, not on the other rows.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from haconvdr_torch.data.loader import batch_iter
from haconvdr_torch.device import to_numpy, to_torch
from haconvdr_torch.parallel.mesh import Mesh, batch_slices, replicate

__all__ = ["batch_iter", "dp_encode_fn", "encode_batches"]

EncodeFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _device_of(fn) -> Optional[torch.device]:
    return next(fn.parameters()).device if isinstance(fn, torch.nn.Module) else None


def dp_encode_fn(
    mesh: Mesh, encoder_or_fn: Union[EncodeFn, Sequence[EncodeFn]]
) -> Callable[..., torch.Tensor]:
    """``fn(ids, mask, valid=None) -> [B, ...]`` embeddings on the mesh's
    first device, the batch cut over the ``dp`` slots.  ``encoder_or_fn``
    is a module (replicated once to every distinct device of the mesh), a
    list of one encoder a slot (``mesh.replicate``'s), or a callable that
    runs on whichever device its inputs are on.  ``valid`` ([B] bool,
    host) skips the slices that hold no valid row; their rows come back
    as zeros."""
    if mesh.shape["tp"] != 1:
        raise NotImplementedError("the tensor-parallel encode (tp > 1) is not ported")
    if isinstance(encoder_or_fn, torch.nn.Module):
        per_slot = replicate(mesh, encoder_or_fn)
    elif isinstance(encoder_or_fn, (list, tuple)):
        per_slot = list(encoder_or_fn)
    else:
        per_slot = [encoder_or_fn] * mesh.size
    devices = list(mesh.devices[:, 0])
    encoders = per_slot[:: mesh.shape["tp"]]

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
    with torch.inference_mode():
        for batch in batches:
            valid = np.asarray(batch["valid"]).astype(bool)
            x = to_torch(batch[key_ids], device)
            m = to_torch(batch[key_mask], device)
            e = fn(x, m, valid) if mesh is not None else fn(x, m)
            embs.append(to_numpy(e)[valid])
            ids.extend(s for s, v in zip(batch["sample_id"], valid) if v)
    return np.concatenate(embs, axis=0), ids
