"""Train-state checkpoint and resume (counterpart of
haconvdr_tpu/train/checkpoint.py).

One ``torch.save`` file per saved micro step, ``state_<step>.pt`` under the
directory, holding the whole train state: the query tower's parameters,
the AdamW moments and count, the accumulation buffer, the micro and global
step counters and the dropout generator's state, so an interrupted run
resumes exactly.  A state trained on a mesh saves its first replica
(``state.model``): the file does not depend on the mesh, and a state saved
on any number of slots resumes on any other.  The format is the port's own: it does not read or write
the JAX package's orbax checkpoints (HF-format weights,
models/hf_import.py, are the interchange format between the packages).
Files are written under a temporary name and renamed into place, and the
newest ``max_to_keep`` are kept.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from haconvdr_torch.train.trainer import TrainState, sync_replicas

_NAME = re.compile(r"^state_(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory) if (m := _NAME.match(f)))


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"state_{step:010d}.pt")


def save_train_state(directory: str, step: int, state: TrainState, max_to_keep: int = 3) -> None:
    os.makedirs(directory, exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "mu": {k: v.cpu() for k, v in state.opt_state.mu.items()},
        "nu": {k: v.cpu() for k, v in state.opt_state.nu.items()},
        "count": state.opt_state.count,
        "accum_grads": {k: v.cpu() for k, v in state.accum_grads.items()},
        "micro_step": state.micro_step,
        "global_step": state.global_step,
        "rng": state.rng.get_state(),
    }
    tmp = _path(directory, step) + f".tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, _path(directory, step))
    for old in _steps(directory)[:-max_to_keep]:
        os.unlink(_path(directory, old))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_train_state(
    directory: str, like: TrainState, step: Optional[int] = None
) -> TrainState:
    """Restore into ``like`` (an initialised TrainState on the target
    mesh's first device), in place, and return it; every replica of
    ``like`` gets the restored parameters."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no train-state checkpoint under {directory}")
    saved = torch.load(_path(directory, step), map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k, v in like.model.state_dict().items():
            v.copy_(saved["params"][k])
        for name in ("mu", "nu"):
            for k, v in getattr(like.opt_state, name).items():
                v.copy_(saved[name][k])
        for k, v in like.accum_grads.items():
            v.copy_(saved["accum_grads"][k])
    like.opt_state.count = saved["count"]
    like.micro_step = saved["micro_step"]
    like.global_step = saved["global_step"]
    like.rng.set_state(saved["rng"])
    sync_replicas(like)
    return like
