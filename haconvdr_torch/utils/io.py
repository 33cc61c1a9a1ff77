"""Host-side IO helpers.

Replaces the reference utility belt (src/utils.py:34-111): directory
management, pickle load/store, jsonl streaming, seeding; and the one
reader and writer of the ``.npy`` arrays the IVF indexes persist
(bfloat16 as ``np.save`` of ml_dtypes writes it, without ml_dtypes), with
the pinned, double-buffered copy of a saved array to the card.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import random
from typing import Any, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

LOAD_BYTES = 1 << 28  # bytes per host -> device copy when loading a saved array


def ensure_dirs(*dirs: str) -> None:
    """mkdir -p for each path (src/utils.py:34-41, minus the rmtree mode)."""
    for d in dirs:
        if d:
            os.makedirs(d, exist_ok=True)


def pload(path: str) -> Any:
    """Pickle load (src/utils.py:65-69)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def pstore(obj: Any, path: str) -> None:
    """Pickle store, protocol 4 as the reference block files use
    (gen_doc_embeddings.py:131-135)."""
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=4)


def read_jsonl(path: str) -> Iterator[dict]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def read_jsonl_list(path: str) -> List[dict]:
    return list(read_jsonl(path))


def write_jsonl(records: Iterable[dict], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec))
            f.write("\n")


def set_seed(seed: int) -> None:
    """Seed host-side RNGs (src/utils.py:106-111). Device-side randomness
    uses explicit torch.Generators derived from the same seed."""
    random.seed(seed)
    np.random.seed(seed)


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )


def parse_kv_args(argv: Iterable[str]) -> dict:
    """``key=value`` CLI argument parser shared by the artifact CLIs
    (cli/ivf_sweep.py, cli/build_ivf.py)."""
    out = {}
    for a in argv:
        k, eq, v = str(a).partition("=")
        if not eq:
            raise SystemExit(f"expected key=value, got {a!r}")
        out[k] = v
    return out


def save_npy(path: str, t: torch.Tensor) -> None:
    """``np.save`` of a tensor.  bfloat16 is written as ``np.save`` writes
    an ml_dtypes bfloat16 array (raw 2-byte records, descr ``'<V2'``), byte
    for byte, without needing ml_dtypes."""
    t = t.detach().contiguous().cpu()
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    raw = t.view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": tuple(raw.shape)}
        )
        raw.tofile(f)


def open_npy(path: str) -> Tuple[np.ndarray, torch.dtype]:
    """(memory-mapped array, torch dtype) of a ``.npy`` file; raw 2-byte
    records (bfloat16 as ``np.save`` writes it) come back as int16 bits."""
    arr = np.load(path, mmap_mode="r")
    if arr.dtype == np.dtype("V2"):
        return arr.view(np.int16), torch.bfloat16
    return arr, torch.from_numpy(np.zeros(0, arr.dtype)).dtype


def rows_to_device(arr: np.ndarray, dtype: torch.dtype, dev: torch.device,
                   out: Optional[torch.Tensor] = None, row0: int = 0) -> torch.Tensor:
    """Copy ``arr`` (e.g. a memory map) to ``dev`` in slices of about
    ``LOAD_BYTES``, into ``out[row0:]`` when given.  The host holds one
    slice at a time; to the card each slice goes through one of two pinned
    buffers, so reading the next slice overlaps the copy of the last."""
    if out is None:
        out, row0 = torch.empty(arr.shape, dtype=dtype, device=dev), 0
    n = arr.shape[0]
    step = max(1, LOAD_BYTES // max(1, arr[:1].nbytes))
    if dev.type != "cuda":
        for r0 in range(0, n, step):
            part = torch.from_numpy(np.array(arr[r0 : r0 + step]))
            out[row0 + r0 : row0 + r0 + part.shape[0]] = part.view(dtype)
        return out
    raw = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    bufs = [torch.empty((min(step, n),) + arr.shape[1:], dtype=raw, pin_memory=True)
            for _ in range(min(2, -(-n // step)))]
    done = [None] * len(bufs)
    for j, r0 in enumerate(range(0, n, step)):
        b, m = j % len(bufs), min(step, n - r0)
        if done[b] is not None:
            done[b].synchronize()  # the copy out of this buffer has finished
        bufs[b][:m].numpy()[...] = arr[r0 : r0 + m]
        out[row0 + r0 : row0 + r0 + m].copy_(bufs[b][:m].view(dtype), non_blocking=True)
        done[b] = torch.cuda.Event()
        done[b].record(torch.cuda.current_stream(dev))
    for ev in done:
        ev.synchronize()
    return out


def load_npy(path: str, dev: torch.device) -> torch.Tensor:
    """The array of a ``.npy`` file as a tensor on ``dev`` (bfloat16 for
    raw 2-byte records), through :func:`rows_to_device`."""
    arr, dtype = open_npy(path)
    return rows_to_device(arr, dtype, dev)
