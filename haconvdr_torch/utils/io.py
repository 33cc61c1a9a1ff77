"""Host-side IO helpers.

Replaces the reference utility belt (src/utils.py:34-111): directory
management, pickle load/store, jsonl streaming, seeding.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import random
from typing import Any, Iterable, Iterator, List

import numpy as np

logger = logging.getLogger(__name__)


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


def load_npy_bf16(path: str, mmap: bool = True):
    """np.load that round-trips bfloat16: np.save stores bf16 arrays as
    raw void-2 records; view them back (index/ivf.py save format,
    parallel/sharded_ivf.py per-shard slabs)."""
    import numpy as np

    arr = np.load(path, mmap_mode="r" if mmap else None)
    if arr.dtype == np.dtype("V2"):
        import ml_dtypes

        arr = arr.view(ml_dtypes.bfloat16)
    return arr
