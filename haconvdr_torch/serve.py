"""Serving API: conversational query -> ranked passage ids (counterpart of
haconvdr_tpu/serve.py).

``Retriever`` holds the query tower and a device-resident flat index (or
streams an EmbeddingBlockStore through ``BlockSearcher``) on one device.
``BatchingRetriever`` coalesces concurrent requests into power-of-two
batches on one worker thread.  Query construction uses the port's
``data.sequence`` helpers and the two-stage rescore its
``index.rescore.StoreRescorer``, copies of the JAX package's.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from haconvdr_torch.config import DataConfig, ModelConfig, SearchConfig
from haconvdr_torch.data.sequence import ConcatBuilder, encode_no_trunc
from haconvdr_torch.device import DeviceLike, resolve_device
from haconvdr_torch.index.rescore import StoreRescorer
from haconvdr_torch.index.store import EmbeddingBlockStore
from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params
from haconvdr_torch.ops.topk import BlockSearcher
from haconvdr_torch.parallel.sharded_encode import batch_iter, encode_batches
from haconvdr_torch.parallel.sharded_search import ShardedIndex

logger = logging.getLogger(__name__)


class Retriever:
    """Query encoder + index on one device.

    ``store`` is an EmbeddingBlockStore, or a [N, D] tensor of embeddings
    already on the device (no disk copy: the rescore stage is then
    unavailable).  ``resident=True`` loads the store into device memory as
    a ``ShardedIndex`` of ``store_dtype`` (float32, bfloat16 or int8; the
    float disk store stays the exact rescore stage, serve.py:109-113);
    ``resident=False`` streams its blocks per search.
    ``params`` are the JAX package's nested-dict params (numpy leaves).
    ``encoder_int8=True`` quantizes them (``quantize_encoder_params``) and
    serves the int8 tower: with ``model_cfg.dtype="bfloat16"`` it runs the
    fused LayerNorm-quant and MLP kernels.
    """

    def __init__(
        self,
        tokenizer,
        params,
        model_cfg: ModelConfig,
        store: Union[EmbeddingBlockStore, torch.Tensor],
        offset2pid: Optional[Sequence[int]] = None,
        data_cfg: Optional[DataConfig] = None,
        search_cfg: Optional[SearchConfig] = None,
        resident: bool = True,
        store_dtype: str = "float32",
        ivf: bool = False,
        encoder_int8: bool = False,
        device: DeviceLike = None,
    ):
        if ivf:
            raise NotImplementedError("IVF serving (index/ivf.py) is not ported yet")
        if encoder_int8:
            # int8 query tower (haconvdr_tpu/serve.py:92-104); the port's
            # quantize_encoder_params leaves int8 params as they are
            params = quantize_encoder_params(params)
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg or DataConfig(is_train=False, use_PRL=False)
        self.search_cfg = search_cfg or SearchConfig()
        self.encoder = AnceEncoder.from_jax_params(params, model_cfg, self.device)
        self.offset2pid = None if offset2pid is None else np.asarray(offset2pid)
        self._rescorer = None
        self.index: Optional[ShardedIndex] = None
        self.store = None
        if isinstance(store, torch.Tensor):
            self._rescore_store = None
            self.index = ShardedIndex.from_tensor(
                store.to(self.device), dtype=store_dtype
            )
        elif resident:
            self._rescore_store = store
            self.index = ShardedIndex.from_store(
                store, dtype=store_dtype, device=self.device
            )
        else:
            self._rescore_store = store
            self.store = store
            # streamed blocks score in float32 whatever store_dtype is,
            # as the JAX package's streaming searcher does (serve.py:214-226)
            cfg = self.search_cfg
            sb_scale = (
                store.global_scale()
                if cfg.superblock_dtype == "int8" and cfg.superblock_rows
                else None
            )
            self.searcher = BlockSearcher(
                top_k=cfg.top_k,
                passage_chunk=cfg.passage_chunk,
                device=self.device,
                superblock_rows=cfg.superblock_rows,
                superblock_dtype=cfg.superblock_dtype,
                superblock_scale=sb_scale,
            )

    # -- query construction -------------------------------------------------
    def build_query(
        self,
        question: str,
        history: Optional[Sequence[Tuple[str, str]]] = None,
        history_passages: Optional[Sequence[str]] = None,
    ) -> Dict:
        """convqp-style input (haconvdr_tpu/serve.py:243): the current
        question, then prior turns newest first (passage, answer,
        question), under the shared truncation rule."""
        d = self.data_cfg
        concat = ConcatBuilder(d.max_concat_length)
        concat.ids.extend(encode_no_trunc(self.tokenizer, question, d.max_query_length))
        history = list(history or [])
        history_passages = list(history_passages or [])
        for t in range(len(history) - 1, -1, -1):
            if t < len(history_passages) and history_passages[t]:
                if not concat.add(
                    encode_no_trunc(self.tokenizer, history_passages[t], d.max_doc_length)
                ):
                    break
            hq, ha = history[t]
            if ha and not concat.add(
                encode_no_trunc(self.tokenizer, ha, d.max_response_length)
            ):
                break
            if not concat.add(encode_no_trunc(self.tokenizer, hq, d.max_query_length)):
                break
        ids, mask = concat.padded()
        return {"sample_id": "q", "conv_qp": ids, "conv_qp_mask": mask}

    # -- retrieval -----------------------------------------------------------
    def embed(self, examples: List[Dict]) -> np.ndarray:
        bs = min(max(1, self.search_cfg.per_device_test_batch_size), len(examples))
        embs, _ = encode_batches(
            self.encoder, batch_iter(examples, bs), "conv_qp", "conv_qp_mask"
        )
        return embs

    def search(
        self, query_embs: np.ndarray, k: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        k = k or self.search_cfg.top_k
        oversample = self.search_cfg.rescore_oversample
        k1 = int(np.ceil(k * oversample)) if oversample > 1.0 else k
        if self.index is not None:
            scores, ids = self.index.search(query_embs, k1)
        else:
            if k1 != self.searcher.top_k:
                self.searcher = self.searcher.with_top_k(k1)
            scores, ids = self.searcher.search(
                query_embs,
                self.store.iter_blocks(self.search_cfg.passage_block_num, with_scales=True),
            )
        if k1 != k:  # exact second stage from the float disk store
            if self._rescore_store is None:
                raise ValueError(
                    "rescore_oversample needs an EmbeddingBlockStore; this "
                    "Retriever was built from a device tensor"
                )
            if self._rescorer is None:
                self._rescorer = StoreRescorer(self._rescore_store)
            scores, ids = self._rescorer.rescore(query_embs, ids, k)
        if self.offset2pid is not None:
            safe = np.clip(ids, 0, len(self.offset2pid) - 1)
            ids = np.where(ids >= 0, self.offset2pid[safe], -1)
        return scores, ids

    def retrieve(
        self,
        question: str,
        history: Optional[Sequence[Tuple[str, str]]] = None,
        history_passages: Optional[Sequence[str]] = None,
        k: Optional[int] = None,
    ) -> List[Tuple[int, float]]:
        """One conversational query -> [(pid, score)] ranked."""
        ex = self.build_query(question, history, history_passages)
        scores, ids = self.search(self.embed([ex]), k)
        return [(int(p), float(s)) for p, s in zip(ids[0], scores[0]) if p >= 0]


class _Request:
    __slots__ = ("example", "k", "future")

    def __init__(self, example: Dict, k: int, future: Future):
        self.example = example
        self.k = k
        self.future = future


_SHUTDOWN = object()


class BacklogFull(RuntimeError):
    """submit() backpressure: the bounded queue is at ``queue_depth``;
    callers should shed load rather than queue without bound."""


class BatchingRetriever:
    """Micro-batching front end over a :class:`Retriever`, with the
    threading contract of haconvdr_tpu/serve.py:359-602.

    * One worker thread owns every device dispatch; callers may submit from
      any number of threads.  Query construction runs in the caller's
      thread at :meth:`submit`.
    * A coalesced batch of n requests runs at the smallest power-of-two
      bucket >= n, capped at ``max_batch``: ``collate(pad_to=bucket)``
      pads the encoder batch, and the search pads the query matrix with
      copies of row 0.
    * The worker dispatches once ``max_batch`` requests are queued or the
      oldest has waited ``max_wait_ms``.  A full queue raises
      :class:`BacklogFull`; :meth:`close` drains accepted work first.
    """

    def __init__(
        self,
        retriever: Retriever,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        queue_depth: int = 1024,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.retriever = retriever
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._closed = threading.Event()
        # makes closed-check-then-enqueue in submit() atomic against close(),
        # so the shutdown sentinel is the last item ever enqueued
        self._submit_gate = threading.Lock()
        self._lock = threading.Lock()
        self._n_queries = 0
        self._n_dispatches = 0
        self._batch_hist: Dict[int, int] = {}
        self._worker = threading.Thread(
            target=self._run, name="haconvdr-torch-batcher", daemon=True
        )
        self._worker.start()

    # -- client API ----------------------------------------------------------
    def submit(
        self,
        question: str,
        history: Optional[Sequence[Tuple[str, str]]] = None,
        history_passages: Optional[Sequence[str]] = None,
        k: Optional[int] = None,
    ) -> Future:
        """Enqueue one conversational query; resolves to [(pid, score)]."""
        top_k = self.retriever.search_cfg.top_k
        k = k or top_k
        if k > top_k:
            raise ValueError(
                f"k={k} exceeds the retriever's top_k={top_k}; raise SearchConfig.top_k"
            )
        ex = self.retriever.build_query(question, history, history_passages)
        fut: Future = Future()
        with self._submit_gate:
            if self._closed.is_set():
                raise RuntimeError("BatchingRetriever is closed")
            try:
                self._q.put_nowait(_Request(ex, int(k), fut))
            except queue.Full:
                raise BacklogFull(
                    f"batcher backlog at queue_depth={self._q.maxsize}; "
                    "retry later or raise queue_depth"
                ) from None
        with self._lock:
            self._n_queries += 1
        return fut

    def retrieve(self, *args, **kw) -> List[Tuple[int, float]]:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(*args, **kw).result()

    def stats(self) -> Dict:
        with self._lock:
            return {
                "queries": self._n_queries,
                "dispatches": self._n_dispatches,
                "batch_histogram": dict(self._batch_hist),
                "backlog": self._q.qsize(),
                "queue_depth": self._q.maxsize,
            }

    def close(self) -> None:
        """Drain in-flight work, then stop the worker.  Idempotent."""
        with self._submit_gate:
            if self._closed.is_set():
                return
            self._closed.set()
        self._q.put(_SHUTDOWN)
        self._worker.join()
        while True:  # nothing should remain, but never hang a caller
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN:
                item.future.set_exception(
                    RuntimeError("BatchingRetriever closed before dispatch")
                )

    def __enter__(self) -> "BatchingRetriever":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker --------------------------------------------------------------
    def _run(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set():
                    # a request accepted just before close() may sit ahead
                    # of the sentinel: dispatch it, do not drop it
                    tail: List[_Request] = []
                    while True:
                        try:
                            item = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if item is _SHUTDOWN:
                            break
                        tail.append(item)
                    while tail:
                        self._dispatch(tail[: self.max_batch])
                        tail = tail[self.max_batch :]
                    return
                continue
            if first is _SHUTDOWN:
                return
            batch = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    stop = True
                    break
                batch.append(nxt)
            self._dispatch(batch)
            if stop:
                return

    def _dispatch(self, batch: List[_Request]) -> None:
        n = len(batch)
        bucket = 1
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, self.max_batch)
        with self._lock:
            self._n_dispatches += 1
            self._batch_hist[n] = self._batch_hist.get(n, 0) + 1
        try:
            r = self.retriever
            embs, _ = encode_batches(
                r.encoder,
                batch_iter([req.example for req in batch], bucket),
                "conv_qp", "conv_qp_mask",
            )
            if n < bucket:  # fixed search shape: pad queries to the bucket
                pad = np.broadcast_to(embs[:1], (bucket - n, embs.shape[1]))
                embs = np.concatenate([embs, pad], axis=0)
            scores, ids = r.search(embs)
            for i, req in enumerate(batch):
                # slice to req.k before the validity filter, as the
                # sequential path does; claim the future before resolving
                hits = [
                    (int(p), float(s))
                    for p, s in zip(ids[i][: req.k], scores[i][: req.k])
                    if p >= 0
                ]
                if req.future.set_running_or_notify_cancel():
                    req.future.set_result(hits)
        except Exception as e:  # surface the failure on every waiter
            logger.exception("batched dispatch failed (%d queries)", n)
            for req in batch:
                if not req.future.done() and req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)
