"""Serving cells of a decoder query tower (DeepSeek-V2): the closed-loop
mix of ``drivers/serve.py`` (its ``closed_loop``, ``qps`` and ``p95_ms``)
over the port's ``BatchingRetriever``, with the tower the configuration
names.

Set-up makes the index rows (bf16) and the tower's bf16 weights on the card
from the seed (``harness/inputs_moe.py``: no host copy of the 31 GB),
builds ``Retriever(params on the card, DeepseekV2Config, rows)`` and warms
every bucket the batcher can dispatch.  Traced runs count the tower's work
with ``harness/work_moe.py`` and hand the readers the expert layer's work
(``expert_work``) and its counters over the window (``ops.moe``).
Afterwards, with the port's state freed, a sample of the answered requests
(the longest among them) is held against the plain float32 reference
(``reference/deepseek_v2.py``, the seed's weights taken to float32 a layer
at a time) and its exact top-k over the same bf16 rows.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np
import torch

from h100_bench.drivers.serve import DEVICE_SPANS, PID_ADD, PID_MUL, Window, closed_loop, warm
from h100_bench.harness import check, inputs, inputs_moe
from h100_bench.harness import traffic as gen
from h100_bench.harness import work as W
from h100_bench.harness import work_moe as WM
from h100_bench.harness.diag import GcPauses, Machine, quantiles, report
from h100_bench.harness.port import release, settle, window_peak_start
from h100_bench.harness.readers import Reading
from h100_bench.harness.trace import Spans, profiler, reduce_profile, window_range
from h100_bench.reference.ance import tf32
from h100_bench.reference.deepseek_v2 import Reference
from h100_bench.reference.embed import ReferenceIndex
from h100_bench.reference.query import convqp_ids
from h100_bench.reference.search import Index
from h100_bench.reference.tokenizer import HashWordTokenizer


def port_params(config: Dict, seed: int, device) -> Dict:
    """The weights the port takes (the float8 control replaces this)."""
    return inputs_moe.make_params(config, seed, device)


def index_rows(config: Dict, seed: int, device) -> torch.Tensor:
    ix = config["index"]
    return inputs.make_rows(ix["rows"], ix["dim"], seed, device).to(torch.bfloat16)


def build(config: Dict, mix: Dict, seed: int, device, marks=None):
    """(Retriever, BatchingRetriever) of the cell, from the seed."""
    from haconvdr_torch.config import DataConfig, SearchConfig
    from haconvdr_torch.models.hf_import import deepseek_v2_config
    from haconvdr_torch.serve import BatchingRetriever, Retriever

    marks = [] if marks is None else marks
    ix = config["index"]
    cfg = deepseek_v2_config(config)
    cfg.dtype = config["tower"]["dtype"]
    marks.append(("imports", time.perf_counter()))
    rows = index_rows(config, seed, device)
    params = port_params(config, seed, device)
    marks.append(("weights and rows", time.perf_counter()))
    retriever = Retriever(
        HashWordTokenizer(config["vocab_size"]), params, cfg, rows,
        offset2pid=np.arange(ix["rows"], dtype=np.int64) * PID_MUL + PID_ADD,
        data_cfg=DataConfig(is_train=False, use_PRL=False,
                            max_concat_length=config["max_concat_length"]),
        search_cfg=SearchConfig(top_k=ix["top_k"], per_device_test_batch_size=mix["max_batch"]),
        device=device, store_dtype=ix["dtype"],
    )
    del params, rows
    marks.append(("Retriever", time.perf_counter()))
    batcher = BatchingRetriever(retriever, max_batch=mix["max_batch"],
                                max_wait_ms=mix["max_wait_ms"])
    return retriever, batcher


def instrument(retriever, spans: Spans, config: Dict, tokens: list) -> None:
    """Spans around build_query, encode and search (traced runs only), each
    carrying the work of its real requests; ``tokens`` gets each encode's
    valid token count."""
    ix = config["index"]
    local = threading.local()
    encode, search = retriever.encode, retriever.search

    def listed(batches):
        batches = list(batches)  # collating inside the span
        local.lengths = [int(m.sum()) for b in batches
                         for m, v in zip(b["conv_qp_mask"], b["valid"]) if v]
        return encode(batches)

    def embed_work(args, kw, out):
        tokens.append(sum(local.lengths))
        return WM.tower_work(local.lengths, config)

    def search_work(args, kw, out):
        return W.search_work(len(local.lengths), ix["rows"], ix["dim"], ix["dtype"],
                             ix["top_k"])

    retriever.build_query = spans.wrap("build_query", retriever.build_query)
    retriever.encode = spans.wrap("embed", listed, embed_work)
    retriever.search = spans.wrap("search", search, search_work)


def _moe_counts() -> Dict:
    """ops.moe's counters, with the device accumulators' (a sync: taken
    while no request is in flight), and ops.pack's masks read back
    (``plan_reads``)."""
    from haconvdr_torch.ops import moe, pack

    return {**moe.COUNTS, **moe.device_counts(), "plan_reads": pack.COUNTS["plan_reads"]}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    config, mix = cell.config, cell.traffic
    if "rate" in mix:
        raise ValueError("serve_decoder drives a closed loop (clients) only")
    k = config["index"]["top_k"]
    marks = [("start", t_start)]
    sess = gen.Sessions(mix, seed)
    retriever, batcher = build(config, mix, seed, device, marks)
    warm(retriever, sess, mix["max_batch"])
    marks.append(("warm-up", time.perf_counter()))
    spans, tokens = None, []
    if trace:
        spans = Spans()
        instrument(retriever, spans, config, tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    settle()
    setup_peak = window_peak_start(device)
    win = Window()
    before = batcher.stats()
    moe_before = _moe_counts()
    prof = profiler(trace)
    if spans is not None:
        spans.on = True
    setup_s = time.perf_counter() - t_start
    with Machine() as machine, prof as p, GcPauses() as pauses:
        with window_range(trace):
            anchor = time.perf_counter()
            t0 = closed_loop(batcher, sess, mix, k, seconds, win)
    if spans is not None:
        spans.on = False
    after = batcher.stats()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    batcher.close()
    moe_after = _moe_counts()
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
                "gen_late_s": None, "p95_ms": e2e["p95_ms"],
                "experts": config["n_routed_experts"],
                "ops.moe": {n: v - moe_before.get(n, 0) for n, v in moe_after.items()},
                "expert_work": None}
    for t in tokens:  # the expert layer's work over the traced window
        counters["expert_work"] = WM.expert_work(t, config).add(
            counters["expert_work"] or W.Work())
    reading = Reading(spans, reduce_profile(p, spans, anchor, DEVICE_SPANS), counters)
    hist = {n: c - before["batch_histogram"].get(n, 0)
            for n, c in after["batch_histogram"].items()}
    report(marks, {
        "latency_ms": quantiles(lat, 1e3), "sent": len(sent), "answered": len(answered),
        "batches": dict(sorted((n, c) for n, c in hist.items() if c)),
        "gc_pauses": {"count": pauses.count, "seconds": [round(x, 4) for x in pauses.seconds]},
        "dispatches": counters["dispatches"], "setup_peak_bytes": setup_peak,
        "tokens_per_dispatch": round(sum(tokens) / len(tokens), 1) if tokens else None,
        "window_ops_moe": counters["ops.moe"], **machine.stats,
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


def reference_queries(config, sess, seed, device, picked) -> torch.Tensor:
    """The reference's embeddings [n, hidden] of requests ``picked``, from
    their text: token ids rebuilt, each request forward alone."""
    tok = HashWordTokenizer(config["vocab_size"])
    L = config["max_concat_length"]
    requests = []
    for j in picked:
        row, n = convqp_ids(tok, *sess.request(j), max_concat=L)
        requests.append(row[:n])
    ref = Reference(config, inputs_moe.make_params(config, seed, device), device)
    q = ref.embed(requests)
    del ref
    return q


def reference_numbers(config, sess, seed, device, picked, answers) -> Dict:
    """rank_gap and score_err of the answers ((passage ids, scores) in
    served order) to requests ``picked``."""
    ix = config["index"]
    q = reference_queries(config, sess, seed, device, picked)
    release(device)
    rows = index_rows(config, seed, device).to(torch.float32)
    index = ReferenceIndex(Index(rows), lambda: tf32(False))
    served = []
    for pid, scores in answers:  # passage ids back to index rows; -1: no row
        r = (pid - PID_ADD) // PID_MUL
        r[(pid - PID_ADD) % PID_MUL != 0] = -1
        r[(r < 0) | (r >= ix["rows"])] = -1
        served.append((r, scores))
    return check.served_numbers(index, q, served, ix["top_k"])
