"""The port's tracer (haconvdr_torch/utils/telemetry.TRACER) on the serving
path, and the benchmark's readings of it (h100_bench/harness/port_trace.py,
h100_bench/metrics/, h100_bench/port_split.py): nothing recorded, no clock
read and no id drawn while it is off, each dispatch's span tree while it
is on, the clock its spans convert to, the idle split and readers on a
synthetic profile, and port_split's wiring on tiny cells."""

import threading
import time

import numpy as np
import pytest
import torch

from h100_bench.harness import port_trace as P
from h100_bench.harness.cell import BENCH_DIR, load_manifest, load_module, reader_path
from h100_bench.harness.readers import Reading
from h100_bench.harness.trace import WINDOW, Span, Spans, reduce
from h100_bench.harness.work import Work
from haconvdr_torch.config import DataConfig, ModelConfig, SearchConfig
from haconvdr_torch.models.convert import init_params_numpy
from haconvdr_torch.serve import BatchingRetriever, Retriever
from haconvdr_torch.utils import telemetry
from haconvdr_torch.utils.telemetry import TRACER, Snapshot, SpanRecord
from haconvdr_torch.utils.testing import HashTokenizer

QUERIES = [
    ("what is the capital of france", [("who wrote hamlet", "shakespeare")]),
    ("and its population", [("capital of france", "paris")]),
    ("tell me about rivers", []),
    ("which one is longest", [("tell me about rivers", "the nile and amazon")]),
    ("how deep is it", []),
]
# children of every dispatch (tower.collate twice: the batch, then the
# iterator's end)
TREE = {"tower.collate": 2, "tower.h2d": 1, "tower.launch": 1, "tower.wait": 1,
        "search.launch": 1, "search.wait": 1, "batcher.resolve": 1}


@pytest.fixture(scope="module")
def retriever():
    cfg = ModelConfig.tiny(vocab_size=512)
    rows = torch.from_numpy(np.random.RandomState(3).randn(60, cfg.embedding_dim)
                            .astype(np.float32))
    return Retriever(
        HashTokenizer(cfg.vocab_size), init_params_numpy(cfg, seed=5), cfg, rows,
        data_cfg=DataConfig(is_train=False, use_PRL=False, max_query_length=12,
                            max_doc_length=16, max_response_length=8, max_concat_length=32),
        search_cfg=SearchConfig(top_k=8, per_device_test_batch_size=4), device="cpu",
    )


@pytest.fixture()
def counted_clock(monkeypatch):
    """TRACER's clock, counting its reads."""
    reads = []

    def now():
        reads.append(1)
        return time.perf_counter_ns()

    monkeypatch.setattr(TRACER, "now", now)
    return reads


def _serve(b):
    futs = [b.submit(q, h) for q, h in QUERIES]
    answers = [f.result(timeout=120) for f in futs]
    assert all(len(a) == 8 for a in answers)
    return answers


def _batcher(retriever, max_batch=4):
    return BatchingRetriever(retriever, max_batch=max_batch, max_wait_ms=50.0)


class _NoDraw:
    """An id counter that fails if an id is drawn."""

    def __next__(self):
        raise AssertionError("an id was drawn while tracing was off")


def test_off_the_tracer_records_nothing_and_reads_no_clock(retriever, counted_clock,
                                                          monkeypatch):
    from haconvdr_torch import serve

    monkeypatch.setattr(serve, "_REQUEST_IDS", _NoDraw())
    monkeypatch.setattr(serve, "_DISPATCH_IDS", _NoDraw())
    assert not TRACER.on
    before = list(TRACER._records)
    with _batcher(retriever) as b:
        _serve(b)
    assert counted_clock == [] and TRACER._records == before
    assert TRACER.span("tower.launch") is telemetry.NULL_SPAN
    assert TRACER.span("request.build", request=None) is telemetry.NULL_SPAN


def _traced(retriever, max_batch=4):
    with _batcher(retriever, max_batch) as b:
        TRACER.start()
        try:
            answers = _serve(b)
        finally:
            snap = TRACER.stop()
    return snap, answers


def test_on_every_dispatch_has_the_span_tree(retriever, counted_clock):
    with _batcher(retriever) as b:
        plain = _serve(b)
    snap, answers = _traced(retriever)
    assert answers == plain  # tracing changes no answer
    assert counted_clock and not TRACER.on
    dispatches = snap.of("batcher.dispatch")
    assert len(dispatches) >= 2  # 5 requests, batches of at most 4
    worker = {d.tid for d in dispatches}
    assert len(worker) == 1 and threading.get_ident() not in worker
    for d in dispatches:
        kids = [s for s in snap.spans if s.parent == d.sid]
        assert {n: sum(1 for s in kids if s.name == n) for n in TREE} == TREE
        assert len(kids) == sum(TREE.values())
        for s in kids:
            assert s.ids["dispatch"] == d.ids["dispatch"] and s.tid == d.tid
            assert d.t0 <= s.t0 <= s.t1 <= d.t1
        waits = [s for s in snap.of("batcher.wait") if s.ids["dispatch"] == d.ids["dispatch"]]
        assert len(waits) == 1 and waits[0].t1 == d.t0 and waits[0].tid == d.tid
    assert sorted(r for d in dispatches for r in d.ids["requests"]) == \
        sorted(s.ids["request"] for s in snap.of("request.build"))
    assert P.dispatches(snap) == len(dispatches) and "batcher" not in snap.counters
    assert snap.counters["ops.fused_attention"]["plain"] == 2 * len(dispatches)  # two layers


def test_encode_corpus_opens_the_tower_spans_once_a_batch(retriever, tmp_path):
    """The index builder runs the serving path's tower loop: 21 passages in
    batches of 8 give one tower.h2d, tower.launch and tower.wait a batch
    (and a tower.collate more, the iterator's end), each batch read back
    after its launch, none inside a dispatch."""
    from haconvdr_torch.index.build import encode_corpus
    from haconvdr_torch.index.store import TokenizedCorpus, TokenizedCorpusWriter

    rng = np.random.default_rng(0)
    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=16)
    for i in range(21):
        w.add(i, rng.integers(3, 512, int(rng.integers(2, 17))).tolist())
    w.finalize()
    TRACER.start()
    try:
        encode_corpus(TokenizedCorpus(str(tmp_path / "c")), retriever.encoder,
                      str(tmp_path / "b"), batch_size=8, device="cpu")
    finally:
        snap = TRACER.stop()
    names = ("tower.collate", "tower.h2d", "tower.launch", "tower.wait")
    assert {n: len(snap.of(n)) for n in names} == dict(zip(names, (4, 3, 3, 3)))
    for launch, wait in zip(snap.of("tower.launch"), snap.of("tower.wait")):
        assert launch.t1 <= wait.t0
    assert all(s.parent is None and "dispatch" not in s.ids for n in names for s in snap.of(n))


def test_a_request_s_spans_share_its_id_and_its_queue_ends_where_its_dispatch_begins(retriever):
    snap, _ = _traced(retriever, max_batch=2)
    builds = {s.ids["request"]: s for s in snap.of("request.build")}
    queued = {s.ids["request"]: s for s in snap.of("request.queue")}
    assert len(builds) == len(QUERIES) and builds.keys() == queued.keys()
    by_dispatch = {d.ids["dispatch"]: d for d in snap.of("batcher.dispatch")}
    for rid, q in queued.items():
        d = by_dispatch[q.ids["dispatch"]]
        assert rid in d.ids["requests"] and q.t1 == d.t0
        assert builds[rid].t1 <= q.t0 <= q.t1 and q.tid is None
        assert builds[rid].tid == threading.get_ident()


def test_a_span_on_another_thread_lands_inside_the_profiler_s_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    ran = []

    def other():
        with TRACER.span("probe.other"):
            time.sleep(0.005)
        ran.append(True)

    TRACER.start()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("probe.range"):
                th = threading.Thread(target=other)
                th.start()
                th.join(timeout=60)
    finally:
        snap = TRACER.stop()
    assert ran and not th.is_alive()
    (rng,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe.range"]
    (sp,) = snap.of("probe.other")
    assert sp.tid != threading.get_ident()
    a, b = snap.profiler_ns(sp.t0), snap.profiler_ns(sp.t1)
    ms = 1_000_000
    assert rng.start_ns() - ms <= a < b <= rng.start_ns() + rng.duration_ns() + ms


# -- the benchmark's readings, on a synthetic profile -------------------------

class _Ev:
    def __init__(self, name, device, start, dur, corr=0, annotation=False):
        self._v = (name, device, start, dur, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


MS = 1_000_000
W = 7 * 10**18  # the profiler's clock at the window's start
PERF = 5 * 10**9  # perf_counter_ns at the same instant
WORKER, CLIENT = 11, 22


def _events():
    return [
        _Ev(WINDOW, "CPU", W, 100 * MS, corr=1, annotation=True),
        _Ev("cudaLaunchKernel", "CPU", W + 12 * MS, 1 * MS, corr=11),
        _Ev("cudaLaunchKernelExC", "CPU", W + 46 * MS, 1 * MS, corr=12),
        _Ev("gemm", "CUDA", W + 20 * MS, 20 * MS, corr=11),
        _Ev("select", "CUDA", W + 50 * MS, 10 * MS, corr=12),
        _Ev("Memcpy HtoD", "CUDA", W + 92 * MS, 2 * MS, corr=13),
    ]


def _bench_spans():
    spans = Spans()  # the benchmark's own, on the host clock (s)
    spans.records = [Span("embed", 5.010, 5.040, Work({"float32": 165e12 * 0.005}, 0.0)),
                     Span("search", 5.045, 5.055, Work({"float32": 0.0}, 3.35e12 * 0.002)),
                     Span("build_query", 5.011, 5.016, None)]
    return spans


def _rec(sid, name, a_ms, b_ms, tid=WORKER, parent=None, **ids):
    return SpanRecord(sid, name, PERF + int(a_ms * MS), PERF + int(b_ms * MS), tid, parent, ids)


def _snapshot():
    """Two dispatches on the worker; the device busy 20-40, 50-60, 92-94 ms."""
    spans = [
        _rec(0, "request.build", 0, 1, CLIENT, request=0),
        _rec(1, "request.queue", 1, 8, None, request=0, dispatch=0),
        _rec(2, "batcher.wait", 2, 8, dispatch=0),
        _rec(3, "batcher.dispatch", 8, 65, dispatch=0, requests=[0]),
        _rec(4, "tower.collate", 8, 10, parent=3, dispatch=0),
        _rec(5, "tower.h2d", 10, 11, parent=3, dispatch=0),
        _rec(6, "tower.launch", 11, 18, parent=3, dispatch=0),
        _rec(7, "tower.wait", 18, 41, parent=3, dispatch=0),
        _rec(8, "search.launch", 44, 47, parent=3, dispatch=0),
        _rec(9, "search.wait", 47, 61, parent=3, dispatch=0),
        _rec(10, "batcher.resolve", 61, 64, parent=3, dispatch=0),
        _rec(11, "request.queue", 5, 70, None, request=1, dispatch=1),
        _rec(12, "batcher.wait", 66, 70, dispatch=1),
        _rec(13, "batcher.dispatch", 70, 96, dispatch=1, requests=[1]),
        _rec(14, "tower.launch", 72, 90, parent=13, dispatch=1),
    ]
    counters = {"ops.fused_attention": {"kernel": 24, "plain": 0},
                "ops.flash_attention": {"fwd": 0, "bwd": 0, "plain_fwd": 3, "plain_bwd": 1},
                "ops.fused_mlp": {"kernel": 12, "plain": 2, "plain_split_up": 5}}
    return Snapshot(W, PERF, spans, counters)


def _trace():
    tr = reduce(_events(), _bench_spans(), 5.0, ("embed", "search"))
    tr.window_start_ns = W
    return tr


def _by_hand():
    """The split counted by hand: the device idles 0-20, 40-50 and 60-92 ms
    (then 94-100, the window's end) and the worker's innermost span is
    the timeline's."""
    idle = [(0, 20), (40, 50), (60, 92)]
    timeline = [(0, 2, "worker.outside"), (2, 8, "batcher.wait"), (8, 10, "tower.collate"),
                (10, 11, "tower.h2d"), (11, 18, "tower.launch"), (18, 41, "tower.wait"),
                (41, 44, "batcher.dispatch"), (44, 47, "search.launch"),
                (47, 61, "search.wait"), (61, 64, "batcher.resolve"),
                (64, 65, "batcher.dispatch"), (65, 66, "worker.outside"),
                (66, 70, "batcher.wait"), (70, 72, "batcher.dispatch"),
                (72, 90, "tower.launch"), (90, 96, "batcher.dispatch")]
    out = {"window end": 6.0}
    for a, b in idle:
        for s0, s1, name in timeline:
            part = min(b, s1) - max(a, s0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
    return {k: v * 1e-3 for k, v in out.items()}


def test_the_idle_split_follows_the_worker_s_innermost_span():
    split = dict(P.idle_by_port(_trace(), _snapshot()))
    want = _by_hand()
    assert split.keys() == want.keys()
    for k in want:
        assert split[k] == pytest.approx(want[k], abs=1e-12), k
    assert split["tower.launch"] == pytest.approx(0.025) and split["batcher.wait"] == \
        pytest.approx(0.010)


def test_idle_gaps_port_sums_to_the_idle_share_of_the_window():
    tr = _trace()
    split = P.idle_by_port(tr, _snapshot())
    idle = (1 - tr.busy_s() / tr.window_s) * tr.window_s
    assert abs(sum(v for _, v in split) - idle) < 1e-9
    assert P.idle_by_port(tr, None) is None
    del tr.window_start_ns  # a trace reduced without the window's start
    assert P.idle_by_port(tr, _snapshot()) is None


def _reader(name):
    return load_module(reader_path(BENCH_DIR, name))


NEW = ("queue_wait_ms", "collate_ms", "launch_ms", "resolve_ms", "idle_wait_ms",
       "idle_host_ms", "plain_calls")
# readers of the port's counters added later: like plain_calls, the window's
# deltas where the reading holds a snapshot, else the process's totals
COUNTER_READERS = ("pack_share",)


def test_the_readers_that_were_there_read_the_same_with_the_snapshot():
    names = [m["name"] for m in load_manifest()["per_layer"]
             if m["name"].split(".")[-1] not in NEW + COUNTER_READERS]
    assert "embed_ms" in names and "open.idle_share" in names
    tr, spans = _trace(), _bench_spans()
    counters = {"queries": 7, "dispatches": 2, "gen_late_s": [0.001, 0.004], "p95_ms": 12.5}
    for name in names:
        plain = _reader(name).read(Reading(spans, tr, counters))
        with_port = _reader(name).read(P.PortReading(spans, tr, counters, port=_snapshot()))
        assert repr(plain) == repr(with_port), name


def test_the_new_readers_return_the_hand_computed_values():
    r = P.PortReading(_bench_spans(), _trace(), {}, port=_snapshot())
    want = _by_hand()
    host = ("batcher.dispatch", "tower.collate", "tower.h2d", "tower.launch",
            "search.launch", "batcher.resolve", "worker.outside")
    assert _reader("idle_wait_ms").read(r) == pytest.approx(want["batcher.wait"] * 1e3 / 2)
    assert _reader("idle_host_ms").read(r) == pytest.approx(
        sum(want[k] for k in host) * 1e3 / 2)
    assert _reader("idle_host_ms").read(r) == pytest.approx((8 + 2 + 1 + 25 + 3 + 3 + 3) / 2)
    assert _reader("plain_calls").read(r) == 0 + 3 + 1 + 2 + 5
    assert _reader("launch_ms").read(r) == pytest.approx((7 + 18) / 2)
    assert _reader("collate_ms").read(r) == pytest.approx(2 / 2)
    assert _reader("resolve_ms").read(r) == pytest.approx(3 / 2)
    assert _reader("queue_wait_ms").read(r) == pytest.approx(np.percentile([7, 65], 95))
    # the open cell's and the encode cell's names find the same files
    assert reader_path(BENCH_DIR, "open.queue_wait_ms") == BENCH_DIR / "metrics" / \
        "queue_wait_ms.py"
    assert reader_path(BENCH_DIR, "encode.plain_calls") == BENCH_DIR / "metrics" / \
        "plain_calls.py"


def test_pack_share_reads_rows_over_slots_of_the_window_or_the_process():
    from haconvdr_torch.ops import pack

    snap = _snapshot()
    snap.counters["ops.pack"] = {"forwards": 2, "slots": 2048, "rows": 64, "valid": 60,
                                 "plan_reads": 0}
    read = _reader("pack_share").read
    assert read(P.PortReading(_bench_spans(), _trace(), {}, port=snap)) == \
        pytest.approx(100 * 64 / 2048)
    # a window whose port has no packing counter (a parent without it)
    assert read(P.PortReading(_bench_spans(), _trace(), {}, port=_snapshot())) is None
    saved = dict(pack.COUNTS)
    try:
        pack.COUNTS.update(slots=1000, rows=250)
        assert read(Reading(_bench_spans(), _trace(), {})) == pytest.approx(25.0)
        pack.COUNTS.update(slots=0, rows=0)  # nothing packed yet
        assert read(Reading(_bench_spans(), _trace(), {})) is None
    finally:
        pack.COUNTS.update(saved)
    assert reader_path(BENCH_DIR, "encode.pack_share") == BENCH_DIR / "metrics" / \
        "pack_share.py"


def test_without_a_snapshot_the_new_readers_find_nothing_but_the_kernel_counters():
    r = Reading(_bench_spans(), _trace(), {})
    for name in NEW[:-1]:
        assert _reader(name).read(r) is None, name
    import haconvdr_torch.ops.fused_attention as fa

    total = _reader("plain_calls").read(r)  # the process's totals
    fa.COUNTS["plain"] += 1
    try:
        assert _reader("plain_calls").read(r) == total + 1
    finally:
        fa.COUNTS["plain"] -= 1


@pytest.mark.parametrize("shift_ms,outside", [(0, 0), (30, 1), (-3, 2)])
def test_the_launch_check_counts_launches_outside_the_worker_s_launching_spans(shift_ms,
                                                                               outside):
    snap = _snapshot()
    snap.perf_ns += shift_ms * MS  # the port's spans placed shift_ms earlier
    # (launches at 12 and 46 ms; 30 earlier puts 46 between tower.wait and
    # search.launch, 3 later puts both before their spans)
    assert P.launches(_events(), snap) == {"launches": 2, "outside": outside}
    assert P.launches(_events()[1:], snap) is None  # no window range


# -- port_split.py's wiring, on tiny cells on the CPU --------------------------

@pytest.mark.parametrize("name", ["f32-sessions-c128", "int8-sessions-open", "int8-encode-384"])
def test_port_split_hands_the_window_s_snapshot_to_a_traced_run(name):
    from h100_bench import port_split
    from h100_bench.harness.runner import execute
    from h100_bench.tests.tiny import tiny_cell

    cell = tiny_cell(name)
    run = cell.driver.run
    wiring = port_split.Wiring(TRACER)
    with wiring.installed(cell):
        line, correct = execute(cell, 2**33 + 7, 1.0, True, torch.device("cpu"),
                                time.perf_counter())
    assert cell.driver.run is run and not TRACER.on  # unwrapped again
    port_split.port_line(line, wiring)
    assert correct and line["correct"]
    port = line["port"]
    # the plain twins run on the CPU: the window's deltas, in the metric too
    assert port["plain_calls"] == P.plain_counts(wiring.snap.counters) > 0
    (metric,) = [m for m in line["metrics"] if m.split(".")[-1] == "plain_calls"]
    assert line["metrics"][metric]["value"] == port["plain_calls"]
    if name == "int8-encode-384":  # no batcher
        assert port == {"dispatches": 0, "plain_calls": port["plain_calls"]}
        assert "idle_gaps_port" not in line["breakdown"]
        assert line["trace_diagnostics"]["port_launches"] is None
        return
    assert port["dispatches"] == len(wiring.snap.of("batcher.dispatch")) > 0
    assert set(port) == {"dispatches", *port_split.PORT_READERS}
    idle = line["device"]["window_s"] - line["device"]["busy_s"]
    assert abs(sum(v for _, v in line["breakdown"]["idle_gaps_port"]) - idle) < 1e-9
    assert line["trace_diagnostics"]["port_launches"] == {"launches": 0, "outside": 0}
