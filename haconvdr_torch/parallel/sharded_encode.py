"""Runs the encoder over collated batches, on one device or over a mesh
(counterpart of haconvdr_tpu/parallel/sharded_encode.py:
encoder_param_pspecs, shard_params, make_sharded_encode_fn and
encode_batches).

``tower_rows`` runs every tower over host batches, for ``encode_batches``
(serving, offline evaluation) and ``index.build.encode_corpus``.  A batch
is a dict of int32 arrays (``batch_iter`` / ``collate``, re-exported
here); the rows its ``valid`` mask leaves out are dropped from the output.

On a mesh each batch is cut over the ``dp`` slots as GSPMD shards
``P("dp", None)``: ``ceil(B / dp)`` rows a slot (a short last slice is
padded to that shape with copies of the batch's first row).  Each dp row
of the mesh runs its slice and the outputs are concatenated in slot order
on the first slot's device.  With replicated params (a module, or
``shard_params(tp=False)``) every tp slot of a dp row holds the same
replica and one of them runs; with split params (``shard_params(tp=True)``:
Megatron column and row splits, ``encoder_param_pspecs``) the tp slots of
the row run their slices together (``models.encoder.encode_split``).  A
slice of padding rows only is not run.  Each batch's host mask goes with
it (``host_mask``) to every encoder that takes one, which packs its rows
from it (``ops.pack``) without reading the mask back from the device.  A
row's embedding is therefore the one it gets among a slice's kept token
rows: it depends on the other rows only through the rounding of the
dense layers over that row count, and on nothing else of the batch.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from haconvdr_torch.config import ModelConfig
from haconvdr_torch.data.loader import batch_iter
from haconvdr_torch.device import DeviceLike, resolve_device, to_numpy, to_torch
from haconvdr_torch.models.convert import encoder_param_pspecs, tp_slice
from haconvdr_torch.ops.pack import takes_host_mask
from haconvdr_torch.parallel.mesh import Mesh, batch_slices, replicate
from haconvdr_torch.utils.telemetry import TRACER

__all__ = ["PIPELINE_DEPTH", "batch_iter", "dp_encode_fn", "encode_batches",
           "encoder_param_pspecs", "shard_params", "tower_rows"]

PIPELINE_DEPTH = 8  # batches in flight on the card before the oldest is read back

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
    """``fn(ids, mask, valid=None, host_mask=None) -> [B, ...]`` embeddings on the mesh's
    first device, the batch cut over the ``dp`` slots.  ``encoder_or_fn``
    is a module (replicated once to every distinct device of the mesh), a
    list of one encoder a slot (``replicate``'s or ``shard_params``'), or
    a callable that runs on whichever device its inputs are on.  A dp row
    runs its first slot's encoder, or, when the slots hold the slices of a
    split tower, the row's group.  ``valid`` ([B] bool, host) skips the
    slices that hold no valid row; their rows come back as zeros.
    ``host_mask`` (numpy [B, L]) goes, sliced as the batch, to the
    encoders that take it (``ops.pack.takes_host_mask``)."""
    if isinstance(encoder_or_fn, torch.nn.Module):
        per_slot = replicate(mesh, encoder_or_fn)
    elif isinstance(encoder_or_fn, (list, tuple)):
        per_slot = list(encoder_or_fn)
    else:
        per_slot = [encoder_or_fn] * mesh.size
    devices = list(mesh.devices[:, 0])
    T = mesh.shape["tp"]
    encoders = [_row_runner(per_slot[i * T : (i + 1) * T]) for i in range(len(devices))]
    takes = [takes_host_mask(enc) for enc in encoders]

    def fn(ids: torch.Tensor, mask: torch.Tensor, valid=None, host_mask=None) -> torch.Tensor:
        B = ids.shape[0]
        host_mask = None if host_mask is None else np.asarray(host_mask)
        slices = batch_slices(B, len(devices))
        per = slices[0][1] - slices[0][0]
        outs: List[Tuple[int, int, torch.Tensor]] = []
        for (a, b), dev, enc, take in zip(slices, devices, encoders, takes):
            if b == a or (valid is not None and not np.asarray(valid[a:b]).any()):
                continue
            x, m = ids[a:b], mask[a:b]
            hm = None if host_mask is None else host_mask[a:b]
            if b - a < per:  # the batch's static slice shape
                fill = per - (b - a)
                x = torch.cat([x, ids[:1].expand(fill, -1)])
                m = torch.cat([m, mask[:1].expand(fill, -1)])
                if hm is not None:
                    hm = np.concatenate([hm, np.repeat(host_mask[:1], fill, 0)])
            kw = {"host_mask": hm} if take and hm is not None else {}
            outs.append((a, b, enc(x.to(dev), m.to(dev), **kw)))
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

        return lambda x, m, host_mask=None: encode_split(group, x, m, host_mask=host_mask)
    return group[0]


@torch.inference_mode()  # entered around each step, left at each yield
def tower_rows(
    encoder_or_fn: Union[torch.nn.Module, EncodeFn, Sequence[EncodeFn]],
    batches: Iterable[dict],
    key_ids: str,
    key_mask: str,
    mesh: Optional[Mesh] = None,
    device: DeviceLike = None,
) -> Iterator[Tuple[np.ndarray, dict]]:
    """The one loop that runs a tower over host batches: yields each
    batch's embeddings (float32 numpy, the rows of its ``valid`` mask where
    it has one) with the batch, in order.  The tower runs on ``device``
    (default: a module's own, else the card), or over a ``mesh``'s dp slots
    (:func:`dp_encode_fn`), and gets each batch's mask as ``host_mask``
    where it takes one.  On CUDA, while more than one batch is at hand, up
    to ``PIPELINE_DEPTH`` batches are in flight: ids and mask go up from
    pinned memory, the embeddings come down into pinned memory marked by an
    event, and the host waits only for the oldest batch.  A lone batch (a
    serving dispatch) overlaps nothing: plain copies, the fewest host calls,
    each a point where another thread may take the interpreter lock."""
    if mesh is not None:
        fn, dev = dp_encode_fn(mesh, encoder_or_fn), mesh.first
    else:
        fn = encoder_or_fn
        dev = resolve_device(device if device is not None else _device_of(fn))
    take = takes_host_mask(fn)
    depth = PIPELINE_DEPTH if dev.type == "cuda" else 0
    inflight: deque = deque()
    batches = iter(batches)
    with TRACER.span("tower.collate"):  # a lazy iterator collates here
        batch = next(batches, None)
    while batch is not None:
        with TRACER.span("tower.collate"):  # one batch ahead
            ahead = next(batches, None)
        piped = depth > 0 and (ahead is not None or len(inflight) > 0)
        valid = None if batch.get("valid") is None else np.asarray(batch["valid"]).astype(bool)
        kw = {"host_mask": np.asarray(batch[key_mask])} if take else {}
        if mesh is not None:
            kw["valid"] = valid
        with TRACER.span("tower.h2d"):  # piped: from pinned memory, not blocking
            x, m = (to_torch(batch[k], "cpu").pin_memory().to(dev, non_blocking=True) if piped
                    else to_torch(batch[k], dev) for k in (key_ids, key_mask))
        with TRACER.span("tower.launch"):
            e = fn(x, m, **kw)
            done = None
            if piped:  # marked on the stream of e's card, which copies e down
                done = torch.cuda.Event()
                stream = torch.cuda.current_stream(e.device)
                e = e.to("cpu", non_blocking=True)  # into pinned memory
                done.record(stream)
        inflight.append((e, done, batch, valid))
        while len(inflight) > depth:
            yield _read_back(*inflight.popleft())
        batch = ahead
    while inflight:
        yield _read_back(*inflight.popleft())


def _read_back(e: torch.Tensor, done, batch: dict, valid) -> Tuple[np.ndarray, dict]:
    with TRACER.span("tower.wait"):
        if done is not None:
            done.synchronize()
        e = to_numpy(e)
    return (e if valid is None else e[valid]), batch


def encode_batches(
    encoder_or_fn: Union[torch.nn.Module, EncodeFn, Sequence[EncodeFn]],
    batches: Iterable[dict],
    key_ids: str,
    key_mask: str,
    mesh: Optional[Mesh] = None,
) -> Tuple[np.ndarray, List]:
    """(embeddings [n_valid, E] float32 numpy, sample ids) over the
    batches: on the encoder's device, or with a ``mesh`` cut over its dp
    slots (:func:`tower_rows`)."""
    embs, ids = [], []
    for e, batch in tower_rows(encoder_or_fn, batches, key_ids, key_mask, mesh):
        embs.append(e)
        ids.extend(s for s, v in zip(batch["sample_id"], batch["valid"]) if v)
    return np.concatenate(embs, axis=0), ids
