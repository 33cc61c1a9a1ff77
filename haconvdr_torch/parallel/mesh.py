"""Device mesh (counterpart of haconvdr_tpu/parallel/mesh.py).

A :class:`Mesh` is a ``[dp, tp]`` numpy array of ``torch.device`` slots
with the axis names ``("dp", "tp")``:

* ``dp``: batch (data) parallelism; the encoder and the trained towers
  run one replica per distinct device and each batch is split over the
  dp slots, the slots of one tp column (a dp group;
  parallel/sharded_encode.py, train/trainer.py);
* ``tp``: tensor parallelism inside the encoder: the slots of one dp row
  (a tp group) each hold one Megatron slice of the tower and run a layer
  together (models/encoder.py, parallel/sharded_encode.py); training
  replicates over it, as JAX's ``P("dp", None)`` does (train/trainer.py);
* the index modules flatten the mesh to one axis of ``size`` slots and
  shard the passages (parallel/sharded_search.py) or the clusters
  (parallel/sharded_ivf.py) over it, in row-major slot order.

A device may fill more than one slot.  Several shards then live on one
card, or on the CPU (``make_mesh(devices=["cpu"] * 8)``, the port's
counterpart of the JAX tests' eight virtual CPU devices): each slot keeps
its own shard and runs its own kernels, and the shards' results are
merged on the first slot's device.  Slots on one device share that
device's copy of whatever is replicated.  A group's reductions
(``group_max``, ``group_sum``) move every operand to the group's first
slot and combine them in slot order, so their results do not depend on
timing; an operand already on that device is not copied.

Across processes (``torch.distributed`` initialized), each rank holds a
mesh of its own slots; the global shard order is the ranks' meshes one
after another in rank order, as JAX orders a multi-process mesh by
process.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from haconvdr_torch.device import DeviceLike, resolve_device

AXES = ("dp", "tp")


def _canonical(device: DeviceLike) -> torch.device:
    """A resolved device with its index: bare ``cuda`` is the current card,
    so ``"cuda"`` and ``"cuda:0"`` name one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``[dp, tp]`` array of device slots with axis names ``("dp", "tp")``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...] = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> List[torch.device]:
        """Every slot's device, in row-major order (the shard order)."""
        return list(self.devices.reshape(-1))

    @property
    def distinct(self) -> List[torch.device]:
        """The distinct devices, in order of their first slot."""
        out: List[torch.device] = []
        for d in self.slots:
            if d not in out:
                out.append(d)
        return out

    @property
    def first(self) -> torch.device:
        """The first slot's device, where shard results are merged."""
        return self.devices.reshape(-1)[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.slots]})"


def make_mesh(
    dp: Optional[int] = None,
    tp: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A ``(dp, tp)`` mesh over ``devices``: by default every visible CUDA
    card (``torch.cuda.device_count()``), raising without one.  A device
    listed n times fills n slots."""
    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    slots = [_canonical(d) for d in devices]
    n = len(slots)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = slots
    return Mesh(arr.reshape(dp, tp))


def replicate(mesh: Mesh, x) -> List:
    """``x`` on every slot, one entry per slot in row-major order; slots on
    one device share one copy.  A tensor is copied with ``.to``; a module
    stays itself on its own device and is deep-copied to every other."""
    copies: Dict[torch.device, object] = {}
    if isinstance(x, torch.nn.Module):
        home = next(x.parameters()).device
        home = _canonical(home) if home.type == "cuda" else home
        for dev in mesh.distinct:
            copies[dev] = x if dev == home else copy.deepcopy(x).to(dev)
    else:
        for dev in mesh.distinct:
            copies[dev] = x.to(dev)
    return [copies[d] for d in mesh.slots]


def batch_slices(batch: int, n: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of ``n`` slices of ``batch`` rows as GSPMD
    shards a leading axis: ``ceil(batch / n)`` rows each, the last short or
    empty."""
    per = -(-batch // n) if batch else 0
    return [(min(i * per, batch), min((i + 1) * per, batch)) for i in range(n)]


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: str = "dp") -> List[torch.Tensor]:
    """The leading dimension of ``x`` split over ``axis`` (``batch_slices``),
    each slice on the device of its slot along that axis (the first slot
    of the other axis)."""
    devs = list(np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)[:, 0])
    return [x[a:b].to(d) for (a, b), d in zip(batch_slices(x.shape[0], len(devs)), devs)]


def group_max(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise maximum of a group's tensors (one a slot, in slot
    order), on the first one's device: each other operand is moved there
    (a tensor already on it is not copied) and combined in slot order, so
    the result does not depend on timing."""
    first = tensors[0].device
    out = tensors[0]
    for t in tensors[1:]:
        out = torch.maximum(out, t.to(first))
    return out


def group_sum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise sum of a group's tensors, as ``group_max`` combines
    them: ``((t0 + t1) + t2) + ...`` on the first one's device, in their
    dtype (int32 partial products stay int32, and exact)."""
    first = tensors[0].device
    out = tensors[0]
    for t in tensors[1:]:
        out = out + t.to(first)
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def dist_rank_world() -> Tuple[int, int]:
    """(rank, world size) of an initialized ``torch.distributed`` group,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """``torch.distributed.barrier()`` when a group of more than one rank is
    initialized."""
    if dist_rank_world()[1] > 1:
        torch.distributed.barrier()
