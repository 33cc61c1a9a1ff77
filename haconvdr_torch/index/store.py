"""On-disk stores for the offline indexing pipeline.

Replaces the reference's artifact formats with memmap-friendly layouts:

  * :class:`TokenizedCorpus` — fixed-shape int32 token matrix + lengths +
    pids, replacing the hand-rolled byte-record ``passages`` file +
    ``EmbeddingCache`` reader (gen_tokenized_doc.py:36-87,161-197;
    src/utils.py:300-350).  Zero-copy batch slicing via np.memmap — no
    per-record seek/parse loop on the encode path.
  * :class:`EmbeddingBlockStore` — embedding blocks as .npy pairs
    (emb [N,768] + ids [N]), replacing the pickle blocks
    ``passage_emb_block_{i}.pb`` / ``passage_embid_block_{i}.pb``
    (gen_doc_embeddings.py:127-155); reads the reference pickle format too
    for artifact interop.  Missing middle blocks raise instead of silently
    truncating the corpus (reference bug: bare ``except: break`` at
    src/test_HAConvDR_topiocqa.py:81-95).
  * :class:`ReferenceEmbeddingCacheReader` — reads the reference's binary
    tokenized-passage format directly.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterator, List, Optional, Tuple

import numpy as np

from haconvdr_torch.utils.io import pload, pstore


class TokenizedCorpusWriter:
    """Append-only writer; call ``finalize`` to write metadata and the
    pid<->offset maps (pickles kept for reference interop,
    gen_tokenized_doc.py:185-197)."""

    def __init__(self, out_dir: str, max_seq_length: int):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.max_seq_length = max_seq_length
        self._tok_f = open(os.path.join(out_dir, "tokens.bin"), "wb")
        self._len_f = open(os.path.join(out_dir, "lengths.bin"), "wb")
        self._pid_f = open(os.path.join(out_dir, "pids.bin"), "wb")
        self.count = 0

    def add(self, pid: int, token_ids: List[int]) -> None:
        L = self.max_seq_length
        ids = np.zeros(L, np.int32)
        n = min(len(token_ids), L)
        ids[:n] = token_ids[:n]
        self._tok_f.write(ids.tobytes())
        self._len_f.write(np.int32(n).tobytes())
        self._pid_f.write(np.int64(pid).tobytes())
        self.count += 1

    def add_batch(self, pids: np.ndarray, ids: np.ndarray, lens: np.ndarray) -> None:
        assert ids.shape[1] == self.max_seq_length
        self._tok_f.write(np.ascontiguousarray(ids, np.int32).tobytes())
        self._len_f.write(np.ascontiguousarray(lens, np.int32).tobytes())
        self._pid_f.write(np.ascontiguousarray(pids, np.int64).tobytes())
        self.count += len(pids)

    def finalize(self) -> None:
        self._tok_f.close()
        self._len_f.close()
        self._pid_f.close()
        meta = {
            "type": "int32",
            "total_number": self.count,
            "max_seq_length": self.max_seq_length,
        }
        with open(os.path.join(self.out_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        pids = np.memmap(
            os.path.join(self.out_dir, "pids.bin"), dtype=np.int64, mode="r"
        )
        pid2offset = {int(p): i for i, p in enumerate(pids)}
        offset2pid = [int(p) for p in pids]
        pstore(pid2offset, os.path.join(self.out_dir, "pid2offset.pickle"))
        pstore(offset2pid, os.path.join(self.out_dir, "offset2pid.pickle"))


class TokenizedCorpus:
    """Random-access / batched reader over a TokenizedCorpusWriter output."""

    def __init__(self, dir_path: str):
        with open(os.path.join(dir_path, "meta.json")) as f:
            meta = json.load(f)
        self.total_number = meta["total_number"]
        self.max_seq_length = meta["max_seq_length"]
        n, L = self.total_number, self.max_seq_length
        self.tokens = np.memmap(
            os.path.join(dir_path, "tokens.bin"), dtype=np.int32, mode="r", shape=(n, L)
        )
        self.lengths = np.memmap(
            os.path.join(dir_path, "lengths.bin"), dtype=np.int32, mode="r", shape=(n,)
        )
        self.pids = np.memmap(
            os.path.join(dir_path, "pids.bin"), dtype=np.int64, mode="r", shape=(n,)
        )
        self.dir_path = dir_path

    def __len__(self) -> int:
        return self.total_number

    def batches(
        self, batch_size: int, start: int = 0, stop: Optional[int] = None,
        stride: int = 1, offset: int = 0,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (offsets, token_ids [B,L], mask [B,L]).  ``stride/offset``
        give rank-mod sharding for multi-host encoding, the TPU analog of
        StreamingDataset's rank-mod split (src/utils.py:133-147)."""
        stop = self.total_number if stop is None else stop
        idx_all = np.arange(start + offset, stop, stride)
        L = self.max_seq_length
        for s in range(0, len(idx_all), batch_size):
            idx = idx_all[s : s + batch_size]
            ids = np.asarray(self.tokens[idx])
            lens = np.asarray(self.lengths[idx])
            mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
            yield idx, ids, mask

    def offset2pid(self) -> List[int]:
        return pload(os.path.join(self.dir_path, "offset2pid.pickle"))


class ReferenceEmbeddingCacheReader:
    """Reads the reference's fixed-record binary tokenized-passage file
    (``passages`` + ``passages_meta``, gen_tokenized_doc.py:161-183):
    record = len(4B big-endian) + int32 ids[embedding_size]."""

    def __init__(self, base_path: str):
        with open(base_path + "_meta", "r") as f:
            meta = json.load(f)
        self.dtype = np.dtype(meta["type"])
        self.total_number = meta["total_number"]
        self.max_seq_length = int(meta["embedding_size"])
        self.record_size = self.max_seq_length * self.dtype.itemsize + 4
        self.base_path = base_path

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        L = self.max_seq_length
        with open(self.base_path, "rb") as f:
            offset = 0
            while offset < self.total_number:
                n = min(batch_size, self.total_number - offset)
                raw = f.read(self.record_size * n)
                rec = np.frombuffer(raw, np.uint8).reshape(n, self.record_size)
                lens = (
                    rec[:, :4].astype(np.uint32) @ np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint32)
                ).astype(np.int32)
                ids = rec[:, 4:].copy().view(self.dtype).reshape(n, L)
                mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
                yield np.arange(offset, offset + n), ids.astype(np.int32), mask
                offset += n


class EmbeddingBlockStore:
    """Block store for corpus embeddings.

    Native layout: ``emb_block_{i}.npy`` (float32/bfloat16-as-uint16) +
    ``embid_block_{i}.npy``.  Also reads/writes the reference's pickle
    block format for interop.
    """

    def __init__(self, dir_path: str, fmt: str = "npy"):
        assert fmt in ("npy", "pickle")
        os.makedirs(dir_path, exist_ok=True)
        self.dir_path = dir_path
        self.fmt = fmt

    # -- writing ----------------------------------------------------------
    def write_block(
        self,
        block_id: int,
        emb: np.ndarray,
        ids: np.ndarray,
        scale: Optional[np.ndarray] = None,
    ) -> None:
        """``scale`` ([D] float32): per-dim dequantization scales for int8
        blocks (index/quantize.py), stored as a sidecar.  Native-npy only —
        the reference pickle format has no quantization concept."""
        if self.fmt == "npy":
            np.save(os.path.join(self.dir_path, f"emb_block_{block_id}.npy"), emb)
            np.save(os.path.join(self.dir_path, f"embid_block_{block_id}.npy"), ids)
            if scale is not None:
                np.save(
                    os.path.join(self.dir_path, f"embscale_block_{block_id}.npy"),
                    np.asarray(scale, np.float32),
                )
        else:  # reference pickle format (gen_doc_embeddings.py:127-155)
            assert scale is None, "int8 scale sidecars require fmt='npy'"
            pstore(emb, os.path.join(self.dir_path, f"passage_emb_block_{block_id}.pb"))
            pstore(ids, os.path.join(self.dir_path, f"passage_embid_block_{block_id}.pb"))

    # -- reading ----------------------------------------------------------
    def _paths(self, block_id: int) -> Tuple[str, str]:
        if self.fmt == "npy":
            return (
                os.path.join(self.dir_path, f"emb_block_{block_id}.npy"),
                os.path.join(self.dir_path, f"embid_block_{block_id}.npy"),
            )
        return (
            os.path.join(self.dir_path, f"passage_emb_block_{block_id}.pb"),
            os.path.join(self.dir_path, f"passage_embid_block_{block_id}.pb"),
        )

    def has_block(self, block_id: int) -> bool:
        e, i = self._paths(block_id)
        return os.path.exists(e) and os.path.exists(i)

    def num_blocks(self) -> int:
        n = 0
        while self.has_block(n):
            n += 1
        return n

    def block_size(self, block_id: int) -> int:
        """Row count of one block WITHOUT loading its embeddings: npy
        blocks read only the .npy header; reference-pickle blocks unpickle
        the embid array (~8 B/row) instead of the [N, 768] float matrix
        (~3 KB/row).  Lets ShardedIndex.from_store size its shards without
        streaming the corpus twice."""
        e, i = self._paths(block_id)
        if self.fmt == "npy":
            return int(np.load(e, mmap_mode="r").shape[0])
        with open(i, "rb") as f:
            return len(pickle.load(f))

    def read_block(self, block_id: int) -> Tuple[np.ndarray, np.ndarray]:
        e, i = self._paths(block_id)
        if self.fmt == "npy":
            emb = np.load(e, mmap_mode="r")
            if emb.dtype == np.dtype("V2"):  # np.save round-trips bf16 as raw
                import ml_dtypes

                emb = emb.view(ml_dtypes.bfloat16)
            ids = np.load(i)
        else:
            with open(e, "rb") as f:
                emb = pickle.load(f)
            with open(i, "rb") as f:
                ids = pickle.load(f)
        return emb, np.asarray(ids)

    def block_scale(self, block_id: int) -> Optional[np.ndarray]:
        """Per-dim dequant scales of an int8 block, or None (float block)."""
        p = os.path.join(self.dir_path, f"embscale_block_{block_id}.npy")
        return np.load(p) if self.fmt == "npy" and os.path.exists(p) else None

    def global_scale(self) -> np.ndarray:
        """Corpus-level per-dim dequant scale: the elementwise max over
        every int8 block's scale sidecar.  Because each block scale is
        that block's per-dim abs-max / 127, requantizing any block to this
        scale never clips — the contract BlockSearcher's int8 super-block
        accumulator relies on (ops/topk.py)."""
        out: Optional[np.ndarray] = None
        for b in range(self.num_blocks()):
            s = self.block_scale(b)
            if s is None:
                raise ValueError(
                    f"block {b} has no embscale sidecar — global_scale() "
                    "is only defined for all-int8 stores"
                )
            out = s if out is None else np.maximum(out, s)
        if out is None:
            raise ValueError("empty store: no blocks to derive a scale from")
        return np.asarray(out, np.float32)

    def iter_blocks(
        self, num_blocks: int = -1, with_scales: bool = False
    ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield (emb, ids) per block — or (emb, ids, scale-or-None) with
        ``with_scales=True`` (raw int8 blocks; BlockSearcher folds the
        scale into the queries).  Without ``with_scales``, int8 blocks are
        dequantized to float32 so scale-unaware consumers never score raw
        quantized values.  ``num_blocks=-1``: read until blocks run out; a
        declared-but-missing block raises (no silent truncation, unlike
        src/test_HAConvDR_topiocqa.py:81-95)."""
        if num_blocks < 0:
            num_blocks = self.num_blocks()
        for b in range(num_blocks):
            if not self.has_block(b):
                raise FileNotFoundError(
                    f"embedding block {b} missing under {self.dir_path} "
                    f"(expected {num_blocks} blocks)"
                )
            emb, ids = self.read_block(b)
            scale = self.block_scale(b)
            if emb.dtype == np.int8 and scale is None:
                raise FileNotFoundError(
                    f"int8 block {b} under {self.dir_path} has no "
                    f"embscale_block_{b}.npy sidecar — its codes cannot "
                    "be scored or dequantized"
                )
            if with_scales:
                yield emb, ids, scale
            elif scale is not None:
                from haconvdr_torch.index.quantize import dequantize_int8

                yield dequantize_int8(np.asarray(emb), scale), ids
            else:
                yield emb, ids

    @classmethod
    def open_auto(cls, dir_path: str, num_blocks_hint: int = -1) -> "EmbeddingBlockStore":
        """Detect format: prefer native npy, fall back to reference pickle."""
        for fmt in ("npy", "pickle"):
            store = cls(dir_path, fmt)
            if store.has_block(0):
                return store
        raise FileNotFoundError(f"no embedding blocks found under {dir_path}")
