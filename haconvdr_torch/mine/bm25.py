"""Self-contained BM25 retrieval (counterpart of haconvdr_tpu/mine/bm25.py;
replaces pyserini/Lucene).

The reference mines hard negatives with Lucene via pyserini
(bm25/bm25_topiocqa.py:152-154: ``set_bm25(k1, b)`` +
``batch_search(k=100, threads=20)``; index built by bm25/create_index.sh).
Sparse retrieval is offline and train-time only, so this engine runs on
the host: Lucene-English analysis in Python (mine/analysis.py), a CSR
inverted index in numpy, and the repository's multithreaded C++ scorer
(native/bm25.cpp, loaded via ctypes).

The port builds its own copy of the scorer into
``build/haconvdr_torch/libbm25-<hash>.so``, named by the hash of the
source and the compile command, through a temporary file that
``os.replace`` moves into place, so concurrent processes never load a
half-written library; it never writes under ``native/``.  A failed
build raises.  The numpy term-at-a-time scorer is the plain twin, taken
only when the caller asks for it (``batch_search(..., plain=True)``).

Scoring is Lucene BM25: idf = ln(1 + (N - df + 0.5)/(df + 0.5)),
tf-part = tf / (tf + k1 (1 - b + b dl/avgdl)).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import subprocess
import tempfile
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from haconvdr_torch.mine.analysis import analyze

logger = logging.getLogger(__name__)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC_PATH = os.path.join(_ROOT, "native", "bm25.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "haconvdr_torch")
_CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> str:
    """Where the scorer built from the current source lives."""
    with open(_SRC_PATH, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbm25-{h.hexdigest()[:16]}.so")


def _build_native() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libbm25-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_CXX_FLAGS, "-o", tmp, _SRC_PATH, "-lpthread"],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, so)  # atomic: a reader sees no library or a whole one
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or e
        raise RuntimeError(f"building the BM25 scorer from {_SRC_PATH} failed: {detail}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    logger.info("built the BM25 scorer: %s", so)
    return so


def _load_native():
    lib = ctypes.CDLL(_build_native())
    lib.bm25_index_new.restype = ctypes.c_void_p
    lib.bm25_index_new.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.bm25_index_free.argtypes = [ctypes.c_void_p]
    lib.bm25_index_free.restype = None
    lib.bm25_search_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bm25_search_batch.restype = None
    return lib


_LIB = None


def _lib():
    """The loaded scorer, built on first use; raises if it cannot be built."""
    global _LIB
    if _LIB is None:
        _LIB = _load_native()
    return _LIB


class BM25Index:
    """Inverted index + BM25 search over a passage collection."""

    def __init__(self, stopwords: bool = True, stemming: bool = True):
        self.stopwords = stopwords
        self.stemming = stemming
        self.vocab: Dict[str, int] = {}
        self.doc_ids: List[str] = []
        self._postings: List[Dict[int, int]] = []  # build-time: term -> {doc: tf}
        self._finalized = False

    # -- building ---------------------------------------------------------
    def add(self, doc_id: str, text: str) -> None:
        assert not self._finalized
        tokens = analyze(text, self.stopwords, self.stemming)
        d = len(self.doc_ids)
        self.doc_ids.append(doc_id)
        counts: Dict[int, int] = {}
        for t in tokens:
            tid = self.vocab.setdefault(t, len(self.vocab))
            counts[tid] = counts.get(tid, 0) + 1
        while len(self._postings) < len(self.vocab):
            self._postings.append({})
        if not hasattr(self, "_doc_lens"):
            self._doc_lens: List[int] = []
        self._doc_lens.append(len(tokens))
        for tid, tf in counts.items():
            self._postings[tid][d] = tf

    def add_many(self, docs: Iterable[Tuple[str, str]]) -> None:
        for doc_id, text in docs:
            self.add(doc_id, text)

    def finalize(self) -> None:
        n_terms = len(self.vocab)
        counts = np.array([len(p) for p in self._postings], np.int64)
        self.term_offsets = np.zeros(n_terms + 1, np.int64)
        np.cumsum(counts, out=self.term_offsets[1:])
        n_post = int(self.term_offsets[-1])
        self.post_docs = np.zeros(n_post, np.int32)
        self.post_freqs = np.zeros(n_post, np.int32)
        for tid, posting in enumerate(self._postings):
            o = self.term_offsets[tid]
            docs = sorted(posting)
            self.post_docs[o : o + len(docs)] = docs
            self.post_freqs[o : o + len(docs)] = [posting[d] for d in docs]
        self.doc_lens = np.asarray(self._doc_lens, np.int32)
        self.df = counts
        self.avgdl = float(self.doc_lens.mean()) if len(self.doc_lens) else 1.0
        self._postings = []
        self._finalized = True
        self._native_handle = None

    # -- persistence ------------------------------------------------------
    def save(self, dir_path: str) -> None:
        assert self._finalized
        os.makedirs(dir_path, exist_ok=True)
        np.save(os.path.join(dir_path, "term_offsets.npy"), self.term_offsets)
        np.save(os.path.join(dir_path, "post_docs.npy"), self.post_docs)
        np.save(os.path.join(dir_path, "post_freqs.npy"), self.post_freqs)
        np.save(os.path.join(dir_path, "doc_lens.npy"), self.doc_lens)
        with open(os.path.join(dir_path, "meta.json"), "w") as f:
            json.dump(
                {
                    "doc_ids": self.doc_ids,
                    "vocab": self.vocab,
                    "stopwords": self.stopwords,
                    "stemming": self.stemming,
                },
                f,
            )

    @classmethod
    def load(cls, dir_path: str) -> "BM25Index":
        with open(os.path.join(dir_path, "meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["stopwords"], meta["stemming"])
        idx.vocab = meta["vocab"]
        idx.doc_ids = meta["doc_ids"]
        idx.term_offsets = np.load(os.path.join(dir_path, "term_offsets.npy"))
        idx.post_docs = np.load(os.path.join(dir_path, "post_docs.npy"))
        idx.post_freqs = np.load(os.path.join(dir_path, "post_freqs.npy"))
        idx.doc_lens = np.load(os.path.join(dir_path, "doc_lens.npy"))
        idx.df = np.diff(idx.term_offsets)
        idx.avgdl = float(idx.doc_lens.mean()) if len(idx.doc_lens) else 1.0
        idx._postings = []
        idx._finalized = True
        idx._native_handle = None
        return idx

    # -- searching --------------------------------------------------------
    def _query_terms(self, query: str) -> Tuple[np.ndarray, np.ndarray]:
        """(term_ids, idfs) for the analyzed query; per-occurrence, matching
        Lucene's treatment of repeated query terms."""
        tokens = analyze(query, self.stopwords, self.stemming)
        tids, idfs = [], []
        N = len(self.doc_ids)
        for t in tokens:
            tid = self.vocab.get(t)
            if tid is None:
                continue
            df = float(self.df[tid])
            tids.append(tid)
            idfs.append(np.log(1.0 + (N - df + 0.5) / (df + 0.5)))
        return np.asarray(tids, np.int32), np.asarray(idfs, np.float32)

    def search(
        self, query: str, k: int = 100, k1: float = 0.9, b: float = 0.4
    ) -> List[Tuple[str, float]]:
        docs, scores = self.batch_search([query], k=k, k1=k1, b=b)
        return [
            (self.doc_ids[d], float(s))
            for d, s in zip(docs[0], scores[0])
            if d >= 0
        ]

    def batch_search(
        self,
        queries: Sequence[str],
        k: int = 100,
        k1: float = 0.9,
        b: float = 0.4,
        n_threads: int = 0,
        plain: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (doc_indices [Q, k], scores [Q, k]); -1 pads short lists.
        The pyserini batch_search equivalent (bm25/bm25_topiocqa.py:154).
        ``plain=True`` scores with the numpy twin instead of the native
        scorer."""
        assert self._finalized
        term_lists = [self._query_terms(q) for q in queries]
        offsets = np.zeros(len(queries) + 1, np.int64)
        np.cumsum([len(t[0]) for t in term_lists], out=offsets[1:])
        flat_terms = (
            np.concatenate([t[0] for t in term_lists])
            if term_lists else np.zeros(0, np.int32)
        ).astype(np.int32)
        flat_idfs = (
            np.concatenate([t[1] for t in term_lists])
            if term_lists else np.zeros(0, np.float32)
        ).astype(np.float32)

        out_docs = np.full((len(queries), k), -1, np.int32)
        out_scores = np.zeros((len(queries), k), np.float32)

        if not plain:
            lib = _lib()
            if self._native_handle is None:
                self._native_handle = ctypes.c_void_p(
                    lib.bm25_index_new(
                        len(self.doc_ids),
                        self.doc_lens.ctypes.data_as(ctypes.c_void_p),
                        len(self.vocab),
                        self.term_offsets.ctypes.data_as(ctypes.c_void_p),
                        self.post_docs.ctypes.data_as(ctypes.c_void_p),
                        self.post_freqs.ctypes.data_as(ctypes.c_void_p),
                        0,
                    )
                )
            threads = n_threads or max(1, (os.cpu_count() or 1))
            lib.bm25_search_batch(
                self._native_handle,
                flat_terms.ctypes.data_as(ctypes.c_void_p),
                flat_idfs.ctypes.data_as(ctypes.c_void_p),
                offsets.ctypes.data_as(ctypes.c_void_p),
                len(queries), k1, b, k, threads,
                out_docs.ctypes.data_as(ctypes.c_void_p),
                out_scores.ctypes.data_as(ctypes.c_void_p),
            )
            return out_docs, out_scores

        # the plain twin: term-at-a-time accumulation
        norm = k1 * (1.0 - b + b * self.doc_lens / self.avgdl)
        for qi, (tids, idfs) in enumerate(term_lists):
            acc: Dict[int, float] = {}
            for tid, idf in zip(tids, idfs):
                o0, o1 = self.term_offsets[tid], self.term_offsets[tid + 1]
                docs = self.post_docs[o0:o1]
                tfs = self.post_freqs[o0:o1].astype(np.float32)
                scores = idf * tfs / (tfs + norm[docs])
                for d, s in zip(docs, scores):
                    acc[int(d)] = acc.get(int(d), 0.0) + float(s)
            ranked = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            for r, (d, s) in enumerate(ranked):
                out_docs[qi, r] = d
                out_scores[qi, r] = s
        return out_docs, out_scores
