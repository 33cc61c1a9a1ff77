"""Serving cells: conversational requests through the port's
``BatchingRetriever`` over a ``Retriever`` with a resident flat index.

Set-up makes the weights and the index rows on the card from the seed,
builds ``Retriever(store=<rows on the card>)`` (the port quantizes them
for an int8 index, and the weights for an int8 tower) and warms every
bucket the batcher can dispatch.  The window then sends the mix:

* closed loop (``clients``): one thread keeps that many requests
  outstanding, sending the next as each answer comes; a request's latency
  runs from the call to ``submit`` (query building included) to its
  answer;
* open loop (``rate``): one thread sends on the mix's schedule; a
  request's latency runs from the time it was due.

``qps`` counts the answers that came inside the window over its seconds;
``p95_ms`` is the 95th percentile of every request sent in the window,
those answered after the close included (the run waits for them, at most
``DRAIN_S``).  Afterwards, with the port's state freed, a sample of the
answered requests (the longest among them) is held against the reference.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from h100_bench.harness import check, inputs
from h100_bench.harness import traffic as gen
from h100_bench.harness import work as W
from h100_bench.harness.diag import GcPauses, Machine, quantiles, report
from h100_bench.harness.port import (port_config, release, settle, tower_rates,
                                     window_peak_start)
from h100_bench.harness.readers import Reading
from h100_bench.harness.trace import Spans, profiler, reduce_profile, window_range
from h100_bench.reference.embed import Reference
from h100_bench.reference.query import convqp_ids
from h100_bench.reference.tokenizer import HashWordTokenizer

PID_MUL, PID_ADD = 7, 11  # the passage id of index row r: r x 7 + 11
DRAIN_S = 60.0  # the longest the run waits past the close for answers
DEVICE_SPANS = ("embed", "search")  # the spans that launch work on the card


def build(config: Dict, mix: Dict, seed: int, device, marks=None):
    """(Retriever, BatchingRetriever) of the cell, from the seed; ``marks``
    gets the host clock after each step of set-up."""
    from haconvdr_torch.config import DataConfig, SearchConfig
    from haconvdr_torch.serve import BatchingRetriever, Retriever

    marks = [] if marks is None else marks
    ix = config["index"]
    import haconvdr_torch.serve  # noqa: F401  (the port's imports, timed apart)

    marks.append(("imports", time.perf_counter()))
    params = inputs.make_params(config, seed, device)
    rows = inputs.make_rows(ix["rows"], ix["dim"], seed, device)
    marks.append(("weights and rows", time.perf_counter()))
    retriever = Retriever(
        HashWordTokenizer(config["vocab_size"]), params, port_config(config), rows,
        offset2pid=np.arange(ix["rows"], dtype=np.int64) * PID_MUL + PID_ADD,
        data_cfg=DataConfig(is_train=False, use_PRL=False,
                            max_concat_length=config["max_concat_length"]),
        search_cfg=SearchConfig(top_k=ix["top_k"], per_device_test_batch_size=mix["max_batch"]),
        device=device, store_dtype=ix["dtype"], encoder_int8=config["tower"]["int8"],
    )
    del params, rows
    marks.append(("Retriever", time.perf_counter()))
    batcher = BatchingRetriever(retriever, max_batch=mix["max_batch"],
                                max_wait_ms=mix["max_wait_ms"])
    return retriever, batcher


def warm(retriever, sess: gen.Sessions, max_batch: int) -> None:
    """One dispatch at every bucket the batcher can form, as it forms them."""
    from haconvdr_torch.parallel.sharded_encode import batch_iter

    examples = [retriever.build_query(*sess.request(j)) for j in range(max_batch)]
    bucket = 1
    while bucket <= max_batch:
        embs = retriever.encode(batch_iter(examples[:bucket], bucket))
        retriever.search(embs)
        bucket *= 2


def instrument(retriever, spans: Spans, config: Dict) -> None:
    """Spans around build_query, encode and search (traced runs only),
    each carrying the work of its real requests."""
    ix = config["index"]
    rates = tower_rates(config)
    local = threading.local()
    encode, search = retriever.encode, retriever.search

    def listed(batches):
        batches = list(batches)  # collating inside the span
        local.lengths = [int(m.sum()) for b in batches
                         for m, v in zip(b["conv_qp_mask"], b["valid"]) if v]
        return encode(batches)

    def embed_work(args, kw, out):
        return W.tower_work(local.lengths, config, rates)

    def search_work(args, kw, out):
        return W.search_work(len(local.lengths), ix["rows"], ix["dim"], ix["dtype"],
                             ix["top_k"])

    retriever.build_query = spans.wrap("build_query", retriever.build_query)
    retriever.encode = spans.wrap("embed", listed, embed_work)
    retriever.search = spans.wrap("search", search, search_work)


class Window:
    """What the sending thread saw of each request."""

    def __init__(self):
        self.t_ref: Dict[int, float] = {}  # latency origin: submit (closed) or due (open)
        self.t_done: Dict[int, float] = {}
        self.answer: Dict[int, tuple] = {}  # (passage ids, scores)
        self.failed: List[int] = []
        self.late: List[float] = []
        self.done: "queue.SimpleQueue" = queue.SimpleQueue()

    def send(self, batcher, request, j: int, k: int, origin: float) -> bool:
        from haconvdr_torch.serve import BacklogFull

        self.t_ref[j] = origin
        try:
            fut = batcher.submit(*request, k=k)
        except BacklogFull:
            self.failed.append(j)
            return False
        fut.add_done_callback(lambda f, j=j: self.done.put((j, time.perf_counter(), f)))
        return True

    def take(self, timeout: float) -> bool:
        try:
            j, t, f = self.done.get(timeout=max(timeout, 0.0))
        except queue.Empty:
            return False
        if f.exception() is not None:
            self.failed.append(j)
        else:
            self.t_done[j] = t
            hits = f.result()  # kept as two arrays: no list of tuples outlives the call
            self.answer[j] = (np.fromiter((p for p, _ in hits), np.int64, len(hits)),
                              np.fromiter((s for _, s in hits), np.float64, len(hits)))
        return True


def closed_loop(batcher, sess, mix, k: int, seconds: float, win: Window) -> float:
    t0 = time.perf_counter()
    end = t0 + seconds
    nxt, inflight = 0, 0
    for _ in range(mix["clients"]):
        request = sess.request(nxt)
        inflight += win.send(batcher, request, nxt, k, time.perf_counter())
        nxt += 1
    deadline = end + DRAIN_S
    while inflight and time.perf_counter() < deadline:
        if not win.take(deadline - time.perf_counter()):
            break
        inflight -= 1
        if time.perf_counter() < end:
            request = sess.request(nxt)  # drawn before the request's clock starts
            inflight += win.send(batcher, request, nxt, k, time.perf_counter())
            nxt += 1
    return t0


def open_loop(batcher, requests, due, k: int, seconds: float, win: Window) -> float:
    """``requests`` drawn before the window, sent at ``due`` (s from its start)."""
    t0 = time.perf_counter()
    inflight = 0
    for j, d in enumerate(due):
        target = t0 + float(d)
        while True:  # collect answers while waiting for the next due time
            wait = target - time.perf_counter()
            if wait <= 0 or not win.take(wait):
                break
            inflight -= 1
        win.late.append(time.perf_counter() - target)
        inflight += win.send(batcher, requests[j], j, k, target)
    deadline = t0 + seconds + DRAIN_S
    while inflight and win.take(deadline - time.perf_counter()):
        inflight -= 1
    return t0


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    config, mix = cell.config, cell.traffic
    k = config["index"]["top_k"]
    marks = [("start", t_start)]
    sess = gen.Sessions(mix, seed)
    retriever, batcher = build(config, mix, seed, device, marks)
    warm(retriever, sess, mix["max_batch"])
    marks.append(("warm-up", time.perf_counter()))
    if "rate" in mix:  # the open loop's requests, drawn before its window
        due = gen.arrivals(mix, seconds)
        requests = [sess.request(j) for j in range(len(due))]
        marks.append(("requests drawn", time.perf_counter()))
    spans = None
    if trace:
        spans = Spans()
        instrument(retriever, spans, config)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    settle()
    setup_peak = window_peak_start(device)
    win = Window()
    before = batcher.stats()
    prof = profiler(trace)
    if spans is not None:
        spans.on = True
    setup_s = time.perf_counter() - t_start
    with Machine() as machine, prof as p, GcPauses() as pauses:
        with window_range(trace):
            anchor = time.perf_counter()
            if "rate" in mix:
                t0 = open_loop(batcher, requests, due, k, seconds, win)
            else:
                t0 = closed_loop(batcher, sess, mix, k, seconds, win)
    if spans is not None:
        spans.on = False
    after = batcher.stats()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    batcher.close()
    sent = sorted(win.t_ref)
    answered = sorted(win.answer)
    end = t0 + seconds
    lat = [win.t_done[j] - win.t_ref[j] for j in answered]
    n_short = sum(1 for j in answered if int((win.answer[j][0] >= 0).sum()) < k)
    e2e = {
        "qps": sum(1 for j in answered if win.t_done[j] <= end) / seconds,
        "p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat else float("nan"),
        "setup_s": setup_s,
    }
    counters = {"queries": after["queries"] - before["queries"],
                "dispatches": after["dispatches"] - before["dispatches"],
                "gen_late_s": win.late or None, "p95_ms": e2e["p95_ms"]}
    reading = Reading(spans, reduce_profile(p, spans, anchor, DEVICE_SPANS), counters)
    hist = {n: c - before["batch_histogram"].get(n, 0)
            for n, c in after["batch_histogram"].items()}
    report(marks, {
        "latency_ms": quantiles(lat, 1e3), "sent": len(sent), "answered": len(answered),
        "gen_late_ms": quantiles(win.late, 1e3) if win.late else None,
        "batches": dict(sorted((n, c) for n, c in hist.items() if c)),
        "gc_pauses": {"count": pauses.count, "seconds": [round(x, 4) for x in pauses.seconds]},
        "dispatches": counters["dispatches"], "setup_peak_bytes": setup_peak,
        **machine.stats,
    })
    del retriever, batcher  # the port's state goes before the reference runs
    release(device)
    longest = max(answered, key=sess.words_of) if answered else None
    picked = check.sample(seed, answered, config["check"]["sample"], longest) if answered else []
    numbers = {"missing": float(len(sent) - len(answered) + n_short)}
    if picked:
        numbers.update(reference_numbers(config, sess, seed, device, picked,
                                         [win.answer[j] for j in picked]))
    return {"attempted": len(sent), "failed": len(sent) - len(answered), "e2e": e2e,
            "reading": reading, "numbers": numbers, "memory_peak_bytes": int(memory_peak),
            "window_s": seconds}


def reference_numbers(config, sess, seed, device, picked, answers, control=False) -> Dict:
    """rank_gap and score_err of the answers ((passage ids, scores) in
    served order) to requests ``picked``."""
    ix = config["index"]
    ref = Reference(config, inputs.make_params(config, seed, device), device, control)
    tok = HashWordTokenizer(config["vocab_size"])
    L = config["max_concat_length"]
    ids = np.zeros((len(picked), L), np.int64)
    mask = np.zeros((len(picked), L), np.int64)
    for m, j in enumerate(picked):
        row, n = convqp_ids(tok, *sess.request(j), max_concat=L)
        ids[m] = row
        mask[m, :n] = 1
    q = ref.embed(torch.from_numpy(ids), torch.from_numpy(mask))
    index = ref.index(inputs.make_rows(ix["rows"], ix["dim"], seed, device))
    served = []
    for pid, scores in answers:  # passage ids back to index rows; -1: no row
        rows = (pid - PID_ADD) // PID_MUL
        rows[(pid - PID_ADD) % PID_MUL != 0] = -1
        rows[(rows < 0) | (rows >= ix["rows"])] = -1
        served.append((rows, scores))
    return check.served_numbers(index, q, served, ix["top_k"])
