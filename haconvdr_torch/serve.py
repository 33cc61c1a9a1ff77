"""Serving API: conversational query -> ranked passage ids (counterpart of
haconvdr_tpu/serve.py).

``Retriever`` holds the query tower and a device-resident flat index (or
streams an EmbeddingBlockStore through ``BlockSearcher``) on a mesh of
device slots: one device by default, or ``mesh=`` (parallel/mesh.py),
where the index is sharded over the slots and each batch of queries is
encoded data-parallel over them.
``BatchingRetriever`` coalesces concurrent requests into power-of-two
batches on one worker thread.  Query construction uses the port's
``data.sequence`` helpers and the two-stage rescore its
``index.rescore.StoreRescorer``, copies of the JAX package's.
"""

from __future__ import annotations

import itertools
import logging
import os
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
from haconvdr_torch.models.hf_import import load_checkpoint
from haconvdr_torch.ops.topk import BlockSearcher
from haconvdr_torch.parallel.mesh import Mesh, make_mesh, replicate
from haconvdr_torch.parallel.sharded_encode import batch_iter, encode_batches
from haconvdr_torch.parallel.sharded_ivf import (
    build_ivf_from_store,
    load_ivf_sharded,
    save_ivf_sharded,
    sharded_ivf_search,
)
from haconvdr_torch.parallel.sharded_search import ShardedIndex
from haconvdr_torch.utils.telemetry import NULL_SPAN, TRACER

logger = logging.getLogger(__name__)


class Retriever:
    """Query encoder + index on a mesh of device slots.

    ``mesh=None`` is the one-slot mesh of ``device`` (the card by default).
    With a mesh of more than one slot (haconvdr_tpu/serve.py:91,
    :185-195, :207-210, :278-287): the tower runs one replica a distinct
    device and ``embed`` cuts a batch of ``max(n_dev,
    per_device_test_batch_size * n_dev)`` over the slots; the flat index is
    a ``ShardedIndex.from_store(mesh, ...)``; the IVF index is built with
    ``max(n_shards, (req_nlist // n_shards) * n_shards)`` clusters, where
    ``req_nlist = min(ivf_nlist, rows // 8)``, and a request of
    ``ivf_nprobe`` >= ``req_nlist`` probes them all; a saved IVF directory
    reloads onto the mesh.

    ``store`` is an EmbeddingBlockStore, or a [N, D] tensor of embeddings
    already on the device (no disk copy: the rescore stage is then
    unavailable).  ``resident=True`` loads the store into device memory as
    a ``ShardedIndex`` of ``store_dtype`` (float32, bfloat16 or int8; the
    float disk store stays the exact rescore stage, serve.py:109-113);
    ``resident=False`` streams its blocks per search.
    ``ivf=True`` replaces the flat index with the cluster-pruned IVF index
    (parallel/sharded_ivf.py, one shard): built from the store at
    construction with ``min(ivf_nlist, rows // 8)`` clusters and buckets
    of ``store_dtype`` ("int8": residual codes), probing ``ivf_nprobe``
    clusters a query (default 32; a request >= nlist probes all), or
    reloaded from ``ivf_dir`` when it holds a saved index, which the build
    otherwise writes there.  Its search is exact over the rows it reads
    and reads only the probed buckets and the tail.  On the H100 it is a
    tier of capacity and restart (buckets built once, saved and reloaded
    in seconds; residual int8 codes), not of speed: a single query's
    search is no faster than the flat bfloat16 search, and a batch's is
    slower, since each query scores its own probed buckets
    (``BatchingRetriever`` warns above ``max_batch`` 16).  The float disk
    store stays the exact rescore stage
    (``SearchConfig.rescore_oversample``).
    ``params`` are the JAX package's nested-dict params (numpy leaves).
    With ``model_cfg.model_type`` "DEEPSEEK_V2" (a ``DeepseekV2Config``)
    the tower is ``models.deepseek_v2.DeepseekV2Encoder`` and ``params`` its
    named weights: torch tensors already on the device in the config's
    dtype are taken as they are (no host copy), numpy leaves are cast.
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
        ivf_nlist: int = 1024,
        ivf_nprobe: Optional[int] = None,
        ivf_dir: Optional[str] = None,
        encoder_int8: bool = False,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ):
        # ivf_nlist, ivf_nprobe and ivf_dir are read only with ivf=True, as
        # in the JAX package
        decoder = model_cfg.model_type == "DEEPSEEK_V2"
        if encoder_int8:
            if decoder:
                raise ValueError("the DeepSeek-V2 tower has no int8 route")
            # int8 query tower (haconvdr_tpu/serve.py:92-104); the port's
            # quantize_encoder_params leaves int8 params as they are
            params = quantize_encoder_params(params)
        self.mesh = mesh if mesh is not None else make_mesh(devices=[resolve_device(device)])
        self.device = self.mesh.first
        self.tokenizer = tokenizer
        # a Rust-backed HF tokenizer sets its truncation on every encode and
        # raises "Already borrowed" when two threads encode at once (the
        # HTTP server builds queries in its handler threads)
        self._tokenizer_lock = threading.Lock()
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg or DataConfig(is_train=False, use_PRL=False)
        self.search_cfg = search_cfg or SearchConfig()
        if decoder:
            from haconvdr_torch.models.deepseek_v2 import DeepseekV2Encoder

            self.encoder = DeepseekV2Encoder.from_params(params, model_cfg, self.device)
        else:
            self.encoder = AnceEncoder.from_jax_params(params, model_cfg, self.device)
        # the replicas a batch's slices run on (the tower itself on one slot)
        self._encoders = replicate(self.mesh, self.encoder)
        self.offset2pid = None if offset2pid is None else np.asarray(offset2pid)
        self._rescorer = None
        self.index: Optional[ShardedIndex] = None
        self.ivf_index = None  # an IVFIndex, or a ShardedIVFIndex on a mesh
        self.store = None
        if ivf:
            if isinstance(store, torch.Tensor):
                raise ValueError("ivf=True builds from an EmbeddingBlockStore, not a tensor")
            self._rescore_store = store
            self.ivf_index = self._ivf(store, store_dtype, ivf_nlist, ivf_nprobe, ivf_dir)
        elif isinstance(store, torch.Tensor):
            self._rescore_store = None
            self.index = ShardedIndex.from_tensor(
                store.to(self.device), dtype=store_dtype, mesh=self.mesh
            )
        elif resident:
            self._rescore_store = store
            self.index = ShardedIndex.from_store(self.mesh, store, dtype=store_dtype)
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

    def _ivf(self, store, store_dtype, ivf_nlist, ivf_nprobe, ivf_dir):
        """The IVF index of ``store`` on the mesh (haconvdr_tpu/serve.py:115-205):
        reloaded from ``ivf_dir`` when it holds one, else built from the
        store (and saved to ``ivf_dir``) with nlist rounded to the shard
        count.  A request of ``ivf_nprobe`` >= the requested nlist probes
        every cluster.  The reload refuses a directory whose bucket dtype is
        not ``store_dtype`` or whose valid-row count is not the store's
        (block headers only)."""
        n_rows = sum(store.block_size(b) for b in range(store.num_blocks()))
        req_nlist = min(ivf_nlist, max(1, n_rows // 8))
        if ivf_dir and os.path.exists(os.path.join(ivf_dir, "ivf_sharded_meta.json")):
            idx, meta = load_ivf_sharded(ivf_dir, with_meta=True, mesh=self.mesh)
            saved_dtype = meta.get("bucket_dtype")
            if saved_dtype is not None and saved_dtype != store_dtype:
                raise ValueError(
                    f"ivf_dir {ivf_dir!r} holds {saved_dtype} buckets "
                    f"but store_dtype={store_dtype!r} was requested; "
                    "rebuild (remove the dir) or match store_dtype"
                )
            saved_rows = meta.get("corpus_rows")
            if saved_rows is not None and n_rows != saved_rows:
                raise ValueError(
                    f"ivf_dir {ivf_dir!r} was built from {saved_rows} corpus "
                    f"rows but the store now has {n_rows}; the persisted index "
                    "is stale — remove the dir to rebuild"
                )
            if ivf_nprobe is not None:
                # the build's probe-everything rule, so identical arguments
                # serve identical results across a restart
                nlist = idx.centroids.shape[0]
                idx = idx._replace(nprobe=int(nlist if ivf_nprobe >= req_nlist else ivf_nprobe))
            return idx
        n_shards = self.mesh.size
        nlist = max(n_shards, (req_nlist // n_shards) * n_shards)
        want = 32 if ivf_nprobe is None else ivf_nprobe
        idx = build_ivf_from_store(
            self.mesh, store, nlist=nlist, nprobe=nlist if want >= req_nlist else want,
            dtype=store_dtype,
        )
        if ivf_dir:  # the next load skips the build
            save_ivf_sharded(idx, ivf_dir)
        return idx

    @classmethod
    def load(
        cls,
        checkpoint_path: str,
        embeddings_dir: str,
        model_type: str = "ANCE",
        **kw,
    ) -> "Retriever":
        """A Retriever from an HF checkpoint (weights and the tokenizer
        saved beside them) and an embeddings directory
        (haconvdr_tpu/serve.py:229-240).  ``kw`` goes to ``Retriever``,
        ``device`` included."""
        if kw.get("mesh") is None:
            resolve_device(kw.get("device"))  # raises without the card before any read
        tokenizer, params, model_cfg = load_checkpoint(model_type, checkpoint_path)
        store = EmbeddingBlockStore.open_auto(embeddings_dir)
        return cls(tokenizer, params, model_cfg, store, **kw)

    # -- query construction -------------------------------------------------
    def build_query(
        self,
        question: str,
        history: Optional[Sequence[Tuple[str, str]]] = None,
        history_passages: Optional[Sequence[str]] = None,
    ) -> Dict:
        """convqp-style input (haconvdr_tpu/serve.py:243): the current
        question, then prior turns newest first (passage, answer,
        question), under the shared truncation rule.  Safe from any number
        of threads: the tokenizer is used by one at a time."""
        with self._tokenizer_lock:
            return self._build_query(question, history, history_passages)

    def _build_query(self, question, history, history_passages) -> Dict:
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
    def encode(self, batches) -> np.ndarray:
        """Embeddings of the valid rows of collated batches, on the mesh."""
        if self.mesh.size == 1:
            return encode_batches(self.encoder, batches, "conv_qp", "conv_qp_mask")[0]
        return encode_batches(self._encoders, batches, "conv_qp", "conv_qp_mask", self.mesh)[0]

    def embed(self, examples: List[Dict]) -> np.ndarray:
        n_dev = self.mesh.size
        per = self.search_cfg.per_device_test_batch_size
        if n_dev == 1:
            bs = min(max(1, per), len(examples))
        else:  # JAX's rule: whole slots, at least one row a slot
            bs = min(max(n_dev, per * n_dev), max(len(examples), n_dev))
        return self.encode(batch_iter(examples, bs))

    def search(
        self, query_embs: np.ndarray, k: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        k = k or self.search_cfg.top_k
        oversample = self.search_cfg.rescore_oversample
        k1 = int(np.ceil(k * oversample)) if oversample > 1.0 else k
        if self.ivf_index is not None:
            scores, ids = sharded_ivf_search(self.mesh, self.ivf_index, query_embs, k=k1)
        elif self.index is not None:
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
    __slots__ = ("example", "k", "future", "id", "enqueued")

    def __init__(self, example: Dict, k: int, future: Future, rid: Optional[int],
                 enqueued: Optional[int]):
        self.example = example
        self.k = k
        self.future = future
        self.id = rid  # drawn only while tracing, as is enqueued
        self.enqueued = enqueued  # TRACER.now() at enqueue


_REQUEST_IDS = itertools.count()  # both taken only while tracing
_DISPATCH_IDS = itertools.count()

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
        if retriever.ivf_index is not None and max_batch > 16:
            # an IVF search scores each query's own probed buckets, so a
            # larger batch does not share their reads (Retriever docstring)
            logger.warning(
                "BatchingRetriever(max_batch=%d) over an IVF retriever: IVF "
                "search does not share its reads across a batch, so the flat "
                "index searches a batch faster.  Use ivf=False for batches.",
                max_batch,
            )
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
        rid = next(_REQUEST_IDS) if TRACER.on else None
        with TRACER.span("request.build", request=rid):
            ex = self.retriever.build_query(question, history, history_passages)
        fut: Future = Future()
        with self._submit_gate:
            if self._closed.is_set():
                raise RuntimeError("BatchingRetriever is closed")
            try:
                enqueued = TRACER.now() if TRACER.on else None
                self._q.put_nowait(_Request(ex, int(k), fut, rid, enqueued))
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
        waited = None  # TRACER.now() when the worker began to wait for a batch
        while True:
            if waited is None and TRACER.on:
                waited = TRACER.now()
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
                        self._dispatch(tail[: self.max_batch], waited)
                        tail = tail[self.max_batch :]
                        waited = TRACER.now() if TRACER.on else None
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
            self._dispatch(batch, waited)
            waited = None
            if stop:
                return

    def _dispatch_span(self, batch: List[_Request], waited: Optional[int]):
        """The dispatch's span while tracing (else ``NULL_SPAN``), after
        recording the worker's wait for the batch (from ``waited``, or
        from the tracer's start if it began earlier or is unknown) and each
        request's time in the queue, which end where the dispatch begins."""
        if not TRACER.on:
            return NULL_SPAN
        d = next(_DISPATCH_IDS)
        t = TRACER.now()
        t_wait = TRACER.started if waited is None else max(waited, TRACER.started)
        TRACER.record("batcher.wait", t_wait, t, threading.get_ident(), dispatch=d)
        for req in batch:
            if req.enqueued is not None:
                TRACER.record("request.queue", req.enqueued, t, None, request=req.id,
                              dispatch=d)
        return TRACER.span("batcher.dispatch", t, dispatch=d,
                           requests=[req.id for req in batch])

    def _dispatch(self, batch: List[_Request], waited: Optional[int]) -> None:
        n = len(batch)
        bucket = 1
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, self.max_batch)
        with self._lock:
            self._n_dispatches += 1
            self._batch_hist[n] = self._batch_hist.get(n, 0) + 1
        with self._dispatch_span(batch, waited):
            try:
                r = self.retriever
                embs = r.encode(batch_iter([req.example for req in batch], bucket))
                if n < bucket:  # fixed search shape: pad queries to the bucket
                    pad = np.broadcast_to(embs[:1], (bucket - n, embs.shape[1]))
                    embs = np.concatenate([embs, pad], axis=0)
                scores, ids = r.search(embs)
                with TRACER.span("batcher.resolve"):
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
