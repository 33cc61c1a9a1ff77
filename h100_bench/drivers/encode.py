"""Corpus-encode cells: the port's ``index.build.encode_corpus`` through
its tower over a tokenized corpus written from the seed, into blocks
under ``TMPDIR``.

Set-up makes the weights on the card from the seed, builds the tower as
the ``gen_doc_embeddings`` entry point does (``quantize_encoder_params``
for an int8 tower, then ``AnceEncoder.from_jax_params``), writes the
corpus (``TokenizedCorpusWriter``) and runs one batch at the batch shape.
The window hands ``encode_corpus`` the corpus's batches until
``--seconds`` have passed and ends when it returns (its in-flight batches
drained and the last block written): ``passages_per_s`` is the passages
stored over that time.  Then a sample of the stored rows (the longest
passage among them) is held against the reference's rows.
"""

from __future__ import annotations

import collections
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from h100_bench.harness import check, inputs
from h100_bench.harness import traffic as gen
from h100_bench.harness import work as W
from h100_bench.harness.diag import Machine, report
from h100_bench.harness.port import (port_config, release, settle, tower_rates,
                                     window_peak_start)
from h100_bench.harness.readers import Reading
from h100_bench.harness.trace import Spans, profiler, reduce_profile, window_range
from h100_bench.reference.embed import Reference

SPANS = ("embed",)  # the tower's span, as in the serving cells


class TimedCorpus:
    """The port's ``TokenizedCorpus``, whose batches stop once the window
    has run ``seconds`` (``start`` begins it); counts the passages handed
    out and keeps each batch's valid lengths for the traced run's work."""

    def __init__(self, corpus, seconds: float):
        self.corpus = corpus
        self.max_seq_length = corpus.max_seq_length
        self.seconds = seconds
        self.end = None
        self.handed = 0
        self.ran_out = False
        self.lengths = collections.deque()

    def start(self) -> None:
        self.end = time.perf_counter() + self.seconds

    def batches(self, batch_size, **kw):
        for batch in self.corpus.batches(batch_size, **kw):
            if time.perf_counter() >= self.end:
                return
            self.handed += len(batch[0])
            self.lengths.append(batch[2].sum(1).tolist())
            yield batch
        self.ran_out = True


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    from haconvdr_torch.index.build import encode_corpus
    from haconvdr_torch.index.store import TokenizedCorpus, TokenizedCorpusWriter
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params

    marks = [("start", t_start), ("imports", time.perf_counter())]
    config, mix = cell.config, cell.traffic
    c = mix["corpus"]
    B, L = c["batch"], c["max_seq_length"]
    params = inputs.make_params(config, seed, device)
    marks.append(("weights", time.perf_counter()))
    if config["tower"]["int8"]:
        params = quantize_encoder_params(params)
    encoder = AnceEncoder.from_jax_params(params, port_config(config), device)
    del params
    marks.append(("tower", time.perf_counter()))
    corpus = gen.Corpus(mix, seed, config["vocab_size"])
    with tempfile.TemporaryDirectory(prefix="h100_bench_encode_") as tmp:
        writer = TokenizedCorpusWriter(os.path.join(tmp, "corpus"), max_seq_length=L)
        for a in range(0, corpus.n, gen.CHUNK):
            b = min(corpus.n, a + gen.CHUNK)
            writer.add_batch(np.arange(a, b, dtype=np.int64), corpus.ids(a, b),
                             corpus.lengths[a:b])
        writer.finalize()
        marks.append(("corpus written", time.perf_counter()))
        timed = TimedCorpus(TokenizedCorpus(os.path.join(tmp, "corpus")), seconds)
        with torch.inference_mode():  # one batch at the batch shape
            _, ids, mask = next(timed.corpus.batches(B))
            encoder(torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))
        encode_fn, spans = encoder, None
        if trace:
            spans = Spans()
            rates = tower_rates(config)

            def batch_work(args, kw, out):
                lengths = timed.lengths.popleft()  # real rows only, read on the host
                return W.tower_work(lengths, config, rates)

            encode_fn = spans.wrap("embed", encoder, batch_work)
            spans.on = True
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        settle()
        setup_peak = window_peak_start(device)
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        with Machine() as machine, profiler(trace) as p:
            with window_range(trace):
                anchor = time.perf_counter()
                timed.start()
                t0 = time.perf_counter()
                store = encode_corpus(timed, encode_fn, os.path.join(tmp, "blocks"),
                                      batch_size=B, per_block_passage_num=c["block"],
                                      store_dtype=config["index"]["dtype"], device=device)
                wall = time.perf_counter() - t0
        if spans is not None:
            spans.on = False
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        del encoder, encode_fn
        release(device)
        rows, scales, offsets = [], [], []
        for b in range(store.num_blocks()):
            codes, offs = store.read_block(b)
            rows.append(np.asarray(codes))
            scales.append(np.broadcast_to(store.block_scale(b), (len(offs), codes.shape[1])))
            offsets.append(np.asarray(offs))
    stored = np.concatenate(offsets) if offsets else np.zeros(0, np.int64)
    n = len(stored)
    numbers = {"offsets_wrong": float(np.sum(stored != np.arange(n)) + (timed.handed - n))}
    if n:
        codes, scale = np.concatenate(rows), np.concatenate(scales)
        longest = int(np.argmax(corpus.lengths[:n]))
        picked = check.sample(seed, list(range(n)), config["check"]["sample"], longest)
        got = codes[picked].astype(np.float32) * scale[picked]
        numbers["row_err"] = row_err(config, corpus, seed, device, picked, got)
    reading = Reading(spans, reduce_profile(p, spans, anchor, SPANS), {"ran_out": timed.ran_out})
    report(marks, {"stored": n, "window_s": wall, "ran_out": timed.ran_out,
                   "blocks": len(offsets), "setup_peak_bytes": setup_peak, **machine.stats})
    return {"attempted": timed.handed, "failed": timed.handed - n,
            "e2e": {"passages_per_s": n / wall, "setup_s": setup_s}, "reading": reading,
            "numbers": numbers, "memory_peak_bytes": int(memory_peak), "window_s": wall}


def row_err(config, corpus, seed, device, picked, got, control=False) -> float:
    """max |got - reference row| / |reference row| over the picked passages."""
    ref = Reference(config, inputs.make_params(config, seed, device), device, control)
    ids = corpus.ids_of(picked).astype(np.int64)
    mask = (np.arange(ids.shape[1])[None, :] < corpus.lengths[picked][:, None]).astype(np.int64)
    want = ref.embed(torch.from_numpy(ids), torch.from_numpy(mask)).double().cpu().numpy()
    err = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    return float(err.max())
