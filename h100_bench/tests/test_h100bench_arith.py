"""The traffic generator, the work and peak arithmetic, and the reduction
of a device trace, on the CPU."""

import json

import numpy as np
import pytest

from h100_bench.harness import traffic as gen
from h100_bench.harness.cell import BENCH_DIR
from h100_bench.harness.peaks import HBM_BYTES_PER_S, PEAK_OPS, least_seconds
from h100_bench.harness.readers import Reading, idle_pct, mfu_pct, roofline_pct
from h100_bench.harness.trace import WINDOW, Span, Spans, reduce
from h100_bench.harness.work import Work, dense_params, search_work, tower_work

CONFIG = json.loads((BENCH_DIR / "configs" / "ance-f32.json").read_text())
SESSIONS = json.loads((BENCH_DIR / "traffic" / "sessions-c128.json").read_text())
OPEN = json.loads((BENCH_DIR / "traffic" / "sessions-open.json").read_text())
ENCODE = json.loads((BENCH_DIR / "traffic" / "encode-384.json").read_text())
F32_TOWER = {"dense": "float32", "attention": "float32", "head": "float32", "weight_bytes": 4}


@pytest.mark.parametrize("seed", [0, 2**33 + 17])
def test_the_same_seed_sends_the_same_traffic(seed):
    a, b = gen.Sessions(SESSIONS, seed), gen.Sessions(SESSIONS, seed)
    assert [a.request(j) for j in (0, 5, 4096 + 3)] == [b.request(j) for j in (0, 5, 4096 + 3)]
    ca, cb = gen.Corpus(ENCODE, seed, 50265), gen.Corpus(ENCODE, seed, 50265)
    assert np.array_equal(ca.ids(4000, 4200), cb.ids(4000, 4200))
    assert np.array_equal(ca.ids_of([4100, 3]), np.concatenate([ca.ids(4100, 4101), ca.ids(3, 4)]))


def test_every_seed_sends_the_same_sizes_in_another_order():
    a, b = gen.Sessions(SESSIONS, 1), gen.Sessions(SESSIONS, 2)
    pool = a.pool
    wa = sorted(a.words_of(j) for j in range(pool))
    wb = sorted(b.words_of(j) for j in range(pool))
    assert wa == wb
    assert [a.words_of(j) for j in range(50)] != [b.words_of(j) for j in range(50)]
    assert a.request(0) != b.request(0)
    due = gen.arrivals(OPEN, 20.0)  # one schedule for every seed
    assert len(due) == round(OPEN["rate"] * 20.0) and 0 < due[0] and due[-1] < 20.0
    assert (np.diff(due) > 0).all()
    gaps = np.diff(due)  # exponential gaps: their spread is their mean
    assert abs(gaps.std() / gaps.mean() - 1) < 0.05
    ca, cb = gen.Corpus(ENCODE, 1, 50265), gen.Corpus(ENCODE, 2, 50265)
    assert np.array_equal(np.sort(ca.lengths), np.sort(cb.lengths))
    ids = ca.ids(0, 64)
    assert (ids[:, 0] == 0).all() and (ids[np.arange(64), ca.lengths[:64] - 1] == 2).all()


def test_the_work_of_a_valid_token_and_of_a_search_worked_example():
    # 12 x (4 x 768^2 + 2 x 768 x 3072) dense parameters: 2 x 84.9M = 170 MFLOP a token
    assert dense_params(CONFIG) == 84_934_656
    w = tower_work([1], CONFIG, F32_TOWER)
    assert w.ops["float32"] == 2 * 84_934_656 + 4 * 768 * 12 + 2 * 768 * 768
    assert abs(2 * 84_934_656 / 170e6 - 1) < 1e-3
    # 300 valid tokens of one request padded to 512: only the 300 count
    w = tower_work([300], CONFIG, F32_TOWER)
    assert w.ops["float32"] == 300 * 2 * 84_934_656 + 4 * 300**2 * 768 * 12 + 2 * 768 * 768
    s = search_work(64, 2_500_000, 768, "float32", 100)
    assert s.nbytes == 2_500_000 * 768 * 4 + 64 * (768 * 4 + 800)  # 7.68 GB a dispatch
    assert abs(2_500_000 * 768 * 4 - 7.68e9) < 1
    assert s.ops["float32"] == 2 * 64 * 2_500_000 * 768
    # the bound of a f32 dispatch of 64 requests: the search's bytes (2.29 ms) against its
    # operations at 165 TFLOP/s (1.49 ms)
    assert least_seconds(dict(s.ops), s.nbytes) == pytest.approx(s.nbytes / HBM_BYTES_PER_S)
    assert PEAK_OPS["float32"] == 495e12 / 3
    # one bound for the whole work: operations of each precision summed, not parts' maxima
    both = Work({"int8": 1979e12, "bfloat16": 989e12}, 3.35e12)
    assert both.least_seconds() == pytest.approx(2.0)


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


def _spans():
    spans = Spans()  # host clock: the window's range opened at 5.0 s
    spans.records = [Span("embed", 5.010, 5.040, Work({"float32": 165e12 * 0.005}, 0.0)),
                     Span("search", 5.045, 5.055, Work({"float32": 0.0}, 3.35e12 * 0.002)),
                     Span("build_query", 5.011, 5.016, None)]
    return spans


def _trace():
    ms = 1_000_000
    w = 7 * 10**18  # the profiler's clock
    ev = [
        _Ev(WINDOW, "CPU", w, 100 * ms, corr=1, annotation=True),
        _Ev("aten::mm", "CPU", w + 12 * ms, 1 * ms, corr=11),  # an op of the same id: not a launch
        _Ev("cudaLaunchKernel", "CPU", w + 12 * ms, 1 * ms, corr=11),  # inside embed
        _Ev("cudaLaunchKernelExC", "CPU", w + 46 * ms, 1 * ms, corr=12),  # inside search
        _Ev("cudaMemcpyAsync", "CPU", w + 90 * ms, 1 * ms, corr=13),  # outside the spans
        _Ev("gemm", "CUDA", w + 20 * ms, 20 * ms, corr=11),
        _Ev("select", "CUDA", w + 50 * ms, 10 * ms, corr=12),
        _Ev("Memcpy HtoD", "CUDA", w + 92 * ms, 2 * ms, corr=13),
        _Ev("embed", "CUDA", w + 20 * ms, 20 * ms, annotation=True),  # not device work
        _Ev("lost", "CUDA", w + 95 * ms, 1 * ms, corr=99),  # no launch seen
    ]
    return reduce(ev, _spans(), 5.0, ("embed", "search"))


def test_the_trace_attributes_device_work_to_the_span_that_launched_it():
    t = _trace()
    assert t.window_s == pytest.approx(0.1)
    assert t.diagnostics == {"device_ops": 4, "launched": 3, "in_spans": 2}
    assert t.span_device_s("embed") == pytest.approx(0.02)
    assert t.span_device_s("search") == pytest.approx(0.01)
    assert t.busy_s() == pytest.approx(0.033)
    assert t.top_ops()[0] == ["gemm", pytest.approx(0.02)]
    gaps = dict(t.idle_gaps())
    assert gaps["embed"] == pytest.approx(0.02) and gaps["search"] == pytest.approx(0.01)
    assert gaps["no span"] == pytest.approx(0.033) and gaps["window end"] == pytest.approx(0.004)


def test_shares_read_the_least_time_over_device_time():
    t = _trace()
    spans = _spans()
    r = Reading(spans, t, {})
    assert roofline_pct(r, "embed") == pytest.approx(25.0)  # 5 ms of 20
    assert roofline_pct(r, "search") == pytest.approx(20.0)  # 2 ms of 10
    assert idle_pct(r) == pytest.approx(67.0)
    assert mfu_pct(r) == pytest.approx(5.0)  # max(5 ms, 2 ms) over 100 ms
    assert roofline_pct(Reading(spans, None, {}), "embed") is None
