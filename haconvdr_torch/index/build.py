"""Corpus encoding into embedding blocks (counterpart of
haconvdr_tpu/index/build.py:encode_corpus, the reference's
gen_doc_embeddings.py:65-158).

``tokenize_collection`` and ``parse_collection_line`` are framework-free
and shared from the JAX package (re-exported here), not copied, as are
the on-disk formats (``TokenizedCorpus`` / ``TokenizedCorpusWriter``,
``EmbeddingBlockStore``).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from haconvdr_tpu.index.build import parse_collection_line, tokenize_collection
from haconvdr_tpu.index.quantize import quantize_int8
from haconvdr_tpu.index.store import EmbeddingBlockStore, TokenizedCorpus, TokenizedCorpusWriter
from haconvdr_torch.device import DeviceLike, resolve_device, to_numpy

__all__ = [
    "EmbeddingBlockStore",
    "TokenizedCorpus",
    "TokenizedCorpusWriter",
    "encode_corpus",
    "parse_collection_line",
    "tokenize_collection",
]

logger = logging.getLogger(__name__)

PIPELINE_DEPTH = 8  # batches in flight before the oldest is read back


def encode_corpus(
    corpus: TokenizedCorpus,
    encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    out_dir: str,
    batch_size: int = 512,
    per_block_passage_num: int = 2_500_000,
    store_dtype: str = "float32",
    fmt: str = "npy",
    stride: int = 1,
    offset: int = 0,
    start_block_id: int = 0,
    device: DeviceLike = None,
) -> EmbeddingBlockStore:
    """Stream-encode the corpus into embedding blocks.

    ``encode_fn(ids, mask)`` takes int32 [B, L] tensors on ``device``
    (default: the device of ``encode_fn``'s parameters when it is a
    module, else the CPU) and returns [B, D] embeddings, or [B, n_chunks, D]
    for a multi-chunk encoder (one row per chunk, chunk-major, each with
    the passage's offset).  As in the JAX package: every batch has the
    static shape [batch_size, L] (the tail is padded with fully masked
    rows whose first mask position is set, and dropped on the host);
    blocks hold whole batches (``per_block_passage_num // batch_size``
    batches); ``store_dtype`` float32, bfloat16 or int8 (float rows
    quantized per block at flush with the shared ``quantize_int8``);
    ``stride``/``offset`` shard the corpus rank-mod and blocks are numbered
    from ``start_block_id``.

    On CUDA, up to ``PIPELINE_DEPTH`` batches are in flight: ids and mask
    go up from pinned memory and embeddings come down into pinned memory
    without blocking, each batch's copy marked by an event, and the host
    waits only for the oldest batch when the pipeline is full.
    """
    if device is None:
        params = encode_fn.parameters() if isinstance(encode_fn, torch.nn.Module) else iter(())
        device = next(params, torch.empty(0)).device
    dev = resolve_device(device)
    store = EmbeddingBlockStore(out_dir, fmt=fmt)
    quantize = store_dtype == "int8"
    if quantize:
        if fmt != "npy":
            raise ValueError("int8 blocks require the native npy format")
        dtype = np.dtype(np.float32)
    elif store_dtype == "bfloat16":
        import ml_dtypes

        dtype = np.dtype(ml_dtypes.bfloat16)
    else:
        dtype = np.dtype(store_dtype)
    # whole batches per block (gen_doc_embeddings.py:87-88)
    block_rows = max(per_block_passage_num // batch_size, 1) * batch_size

    emb_buf: List[np.ndarray] = []
    id_buf: List[np.ndarray] = []
    buffered = 0
    block_id = start_block_id
    total = 0
    t0 = time.time()

    def flush():
        nonlocal emb_buf, id_buf, buffered, block_id, total
        if not buffered:
            return
        emb = np.concatenate(emb_buf, axis=0)
        ids = np.concatenate(id_buf, axis=0)
        if quantize:
            emb, scale = quantize_int8(emb)
            store.write_block(block_id, emb, ids, scale=scale)
        else:
            store.write_block(block_id, emb, ids)
        total += len(emb)
        logger.info(
            "wrote block %d (%d passages, %.1f s elapsed)", block_id, len(emb), time.time() - t0
        )
        block_id += 1
        emb_buf, id_buf, buffered = [], [], 0

    inflight: deque = deque()

    def drain(limit: int) -> None:
        nonlocal buffered
        while len(inflight) > limit:
            host, done, offs, n = inflight.popleft()
            if done is not None:
                done.synchronize()
            emb = to_numpy(host)[:n]
            if emb.ndim == 3:
                # multi-chunk output [B, n_chunks, D]: chunk-major rows, the
                # offsets tiled per chunk (gen_doc_embeddings.py:115-121)
                n_chunks = emb.shape[1]
                emb = np.ascontiguousarray(emb.transpose(1, 0, 2)).reshape(
                    n_chunks * n, emb.shape[2]
                )
                offs = np.tile(offs, n_chunks)
                n = n_chunks * n
            if emb.dtype != dtype:
                emb = emb.astype(dtype)
            emb_buf.append(emb)
            id_buf.append(offs)
            buffered += n
            if buffered >= block_rows:
                flush()

    L = corpus.max_seq_length
    cuda = dev.type == "cuda"
    with torch.inference_mode():
        for offsets, ids, mask in corpus.batches(batch_size, stride=stride, offset=offset):
            n = len(offsets)
            if n < batch_size:  # pad the tail to the static batch shape
                pad = batch_size - n
                ids = np.concatenate([ids, np.zeros((pad, L), np.int32)])
                mask = np.concatenate([mask, np.zeros((pad, L), np.int32)])
                mask[n:, 0] = 1  # no fully masked rows
            ids_t = torch.from_numpy(np.ascontiguousarray(ids, np.int32))
            mask_t = torch.from_numpy(np.ascontiguousarray(mask, np.int32))
            done: Optional[torch.cuda.Event] = None
            if cuda:
                ids_t = ids_t.pin_memory().to(dev, non_blocking=True)
                mask_t = mask_t.pin_memory().to(dev, non_blocking=True)
                host = encode_fn(ids_t, mask_t).to("cpu", non_blocking=True)  # pinned
                done = torch.cuda.Event()
                done.record()
            else:
                host = encode_fn(ids_t.to(dev), mask_t.to(dev))
            inflight.append((host, done, np.asarray(offsets, np.int64), n))
            drain(PIPELINE_DEPTH)
        drain(0)
    flush()
    logger.info("encoded %d passages total", total)
    return store
