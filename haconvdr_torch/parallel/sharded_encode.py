"""Runs the encoder over collated batches on one device (counterpart of
haconvdr_tpu/parallel/sharded_encode.py:encode_batches).

Batches come from ``haconvdr_torch.data.loader`` (``batch_iter`` /
``collate(pad_to=...)``, re-exported here): fixed-size int32 arrays plus
a ``valid`` row mask; padded rows are dropped from the output.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from haconvdr_torch.data.loader import batch_iter
from haconvdr_torch.device import to_numpy, to_torch

__all__ = ["batch_iter", "encode_batches"]


def encode_batches(
    encoder: torch.nn.Module,
    batches: Iterable[dict],
    key_ids: str,
    key_mask: str,
) -> Tuple[np.ndarray, List]:
    """(embeddings [n_valid, E] float32 numpy, sample ids) over the
    batches, on the encoder's device."""
    device = next(encoder.parameters()).device
    embs, ids = [], []
    with torch.inference_mode():
        for batch in batches:
            e = encoder(to_torch(batch[key_ids], device), to_torch(batch[key_mask], device))
            valid = np.asarray(batch["valid"]).astype(bool)
            embs.append(to_numpy(e)[valid])
            ids.extend(s for s, v in zip(batch["sample_id"], valid) if v)
    return np.concatenate(embs, axis=0), ids
