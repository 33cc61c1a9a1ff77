"""Corpus encoding into embedding blocks (counterpart of
haconvdr_tpu/index/build.py:encode_corpus, the reference's
gen_doc_embeddings.py:65-158).

``tokenize_collection`` and ``parse_collection_line`` are the port's own
copies of the JAX package's (haconvdr_tpu/index/build.py:40-163); the
on-disk formats (``TokenizedCorpus`` / ``TokenizedCorpusWriter``,
``EmbeddingBlockStore``, index/store.py) are the same bytes in both
packages.
"""

from __future__ import annotations

import json
import logging
import os
import time
from multiprocessing import Pool
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from haconvdr_torch.config import IndexConfig
from haconvdr_torch.device import DeviceLike
from haconvdr_torch.index.quantize import quantize_int8
from haconvdr_torch.index.store import EmbeddingBlockStore, TokenizedCorpus, TokenizedCorpusWriter
from haconvdr_torch.parallel.sharded_encode import tower_rows

__all__ = [
    "EmbeddingBlockStore",
    "TokenizedCorpus",
    "TokenizedCorpusWriter",
    "encode_corpus",
    "parse_collection_line",
    "tokenize_collection",
]

logger = logging.getLogger(__name__)

_WORKER_TOK = None


def parse_collection_line(
    line: str, ext: str, max_doc_character: int, title: bool = False
) -> Optional[Tuple[int, str, Optional[str]]]:
    """One collection record -> (pid, text, title_or_None).

    Mirrors PassagePreprocessingFn's field handling
    (gen_tokenized_doc.py:200-239): TSV = ``pid\\ttext\\ttitle`` (title mode
    joins the de-[SEP]ed title before the text); JSONL = {id, text, title}
    encoded as a text pair.  Returns None for bad/header lines.
    """
    line = line.strip()
    if not line:
        return None
    if ext == ".jsonl":
        obj = json.loads(line)
        return int(obj["id"]), obj["text"][:max_doc_character], obj["title"]
    # tsv
    arr = line.split("\t")
    if arr[0] == "id":  # header
        return None
    try:
        pid = int(arr[0])
        if title:
            text = arr[2].rstrip().replace(" [SEP] ", " ") + " " + arr[1].rstrip()
        else:
            text = arr[1].rstrip()
    except (IndexError, ValueError):
        return None
    return pid, text[:max_doc_character], None


def _encode_passage(tokenizer, text: str, title: Optional[str], max_seq_length: int) -> List[int]:
    if title is not None:
        return tokenizer.encode(
            title,
            text_pair=text,
            add_special_tokens=True,
            truncation=True,
            max_length=max_seq_length,
        )
    return tokenizer.encode(
        text, add_special_tokens=True, truncation=True, max_length=max_seq_length
    )


def _pool_init(tokenizer_factory):
    global _WORKER_TOK
    _WORKER_TOK = tokenizer_factory()


def _pool_tokenize(args):
    lines, ext, max_doc_character, max_seq_length, title = args
    out = []
    for line in lines:
        parsed = parse_collection_line(line, ext, max_doc_character, title)
        if parsed is None:
            continue
        pid, text, ttl = parsed
        ids = _encode_passage(_WORKER_TOK, text, ttl, max_seq_length)
        out.append((pid, ids))
    return out


def tokenize_collection(
    cfg: IndexConfig,
    tokenizer=None,
    tokenizer_factory=None,
    title: bool = False,
    lines: Optional[Iterable[str]] = None,
) -> TokenizedCorpus:
    """Tokenize the raw collection into ``cfg.data_output_path``.

    Idempotent like the reference ("exists -> exit",
    gen_tokenized_doc.py:147-149): an existing corpus dir is reused.
    Provide either a ``tokenizer`` (in-process) or a picklable
    ``tokenizer_factory`` (for the worker pool).
    """
    out_dir = cfg.data_output_path
    if os.path.exists(os.path.join(out_dir, "meta.json")):
        logger.info("tokenized corpus already exists at %s, skipping", out_dir)
        return TokenizedCorpus(out_dir)

    ext = cfg.raw_collection_path[cfg.raw_collection_path.rfind("."):]
    writer = TokenizedCorpusWriter(out_dir, cfg.max_seq_length)

    def line_iter():
        if lines is not None:
            yield from lines
        else:
            with open(cfg.raw_collection_path, "r", encoding="utf-8") as f:
                yield from f

    t0 = time.time()
    if cfg.num_tokenize_workers > 1 and tokenizer_factory is not None:
        with Pool(
            cfg.num_tokenize_workers, initializer=_pool_init, initargs=(tokenizer_factory,)
        ) as pool:
            def chunk_gen():
                chunk: List[str] = []
                for line in line_iter():
                    chunk.append(line)
                    if len(chunk) >= 10000:
                        yield (chunk, ext, cfg.max_doc_character, cfg.max_seq_length, title)
                        chunk = []
                if chunk:
                    yield (chunk, ext, cfg.max_doc_character, cfg.max_seq_length, title)

            for result in pool.imap(_pool_tokenize, chunk_gen()):
                for pid, ids in result:
                    writer.add(pid, ids)
    else:
        if tokenizer is None:
            raise ValueError("need a tokenizer for in-process tokenization")
        for line in line_iter():
            parsed = parse_collection_line(line, ext, cfg.max_doc_character, title)
            if parsed is None:
                continue
            pid, text, ttl = parsed
            writer.add(pid, _encode_passage(tokenizer, text, ttl, cfg.max_seq_length))

    writer.finalize()
    logger.info(
        "tokenized %d passages in %.1fs -> %s", writer.count, time.time() - t0, out_dir
    )
    return TokenizedCorpus(out_dir)


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
    mesh=None,
) -> EmbeddingBlockStore:
    """Stream-encode the corpus into embedding blocks.

    ``encode_fn(ids, mask)`` takes int32 [B, L] tensors on ``device``
    (default: the device of ``encode_fn``'s parameters when it is a
    module, else the CUDA card) and returns [B, D] embeddings, or [B, n_chunks, D]
    for a multi-chunk encoder (one row per chunk, chunk-major, each with
    the passage's offset); an ``encode_fn`` that takes ``host_mask`` also
    gets each batch's mask as numpy (``ops.pack.takes_host_mask``), from
    which the port's tower packs the batch without reading the mask back.
    The batches run through ``parallel.sharded_encode.tower_rows`` (on
    CUDA, up to ``PIPELINE_DEPTH`` batches in flight), each as the rows it
    holds: a short last batch is not padded, and the tower runs only each
    row's tokens (its kept span, ``ops.pack``) and attention at the
    batch's longest row.
    Blocks hold whole batches (``per_block_passage_num // batch_size``
    batches); ``store_dtype`` float32, bfloat16 or int8 (float rows
    quantized per block at flush with the shared ``quantize_int8``);
    ``stride``/``offset`` shard the corpus rank-mod and blocks are numbered
    from ``start_block_id`` (the multi-process recipe: each process encodes
    its own stride into its own block range of one shared store).  With a
    ``mesh`` (parallel/mesh.py) of more than one slot each batch is cut over
    its ``dp`` slots (parallel/sharded_encode.dp_encode_fn: a module is
    replicated to each of its devices) and the rows come back on the first
    slot's device.
    """
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

    batches = ({"offsets": offs, "ids": ids, "mask": mask}
               for offs, ids, mask in corpus.batches(batch_size, stride=stride, offset=offset))
    dp_mesh = mesh if mesh is not None and mesh.size > 1 else None
    for emb, batch in tower_rows(encode_fn, batches, "ids", "mask", dp_mesh, device):
        offs = np.asarray(batch["offsets"], np.int64)
        n = len(offs)
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
    flush()
    logger.info("encoded %d passages total", total)
    return store
