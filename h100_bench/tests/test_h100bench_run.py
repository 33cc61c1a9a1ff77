"""Whole runs on the CPU at a tiny size: a sound run comes out correct,
each fault a serving or encode cell can have comes out not correct, and
the command refuses to run without a card or without the program."""

import shutil
import subprocess
import sys
import time

import pytest
import torch

from h100_bench import faults
from h100_bench.harness.cell import BENCH_DIR, ROOT
from h100_bench.harness.runner import execute
from h100_bench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SERVE_CELLS = ("f32-sessions-c128", "int8-sessions-open")


def _run(cell, trace=False, seconds=1.0):
    line, correct = execute(cell, 2**33 + 5, seconds, trace, CPU, time.perf_counter())
    return line, correct


def _all_sampled(cell):
    cell.config["check"]["sample"] = 100_000  # every answer of the tiny window is held
    return cell


@pytest.mark.parametrize("name", SERVE_CELLS + ("int8-encode-384",))
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct_and_reports_its_metrics(name, trace):
    cell = tiny_cell(name)
    line, correct = _run(cell, trace)
    assert correct and line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    if trace:
        assert line["device"]["window_s"] > 0 and "breakdown" in line
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        host = {"batch_mean", "build_query_us", "embed_ms", "search_ms", "gen_late_ms"}
        assert set(line["metrics"]) >= host & {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", SERVE_CELLS + ("int8-encode-384",))
@pytest.mark.parametrize("fault", sorted(faults.TOWER_FAULTS))
def test_each_fault_of_the_timed_path_comes_out_not_correct(name, fault):
    with faults.planted(fault):
        _, correct = _run(_all_sampled(tiny_cell(name)))
    assert not correct


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_an_answer_altered_by_the_search_comes_out_not_correct(name):
    with faults.planted("altered_search"):
        _, correct = _run(_all_sampled(tiny_cell(name)))
    assert not correct


def test_the_int4_control_fails_the_int8_limits_on_the_cpu():
    from h100_bench import control

    assert not control.judged(tiny_cell("int8-sessions-open"), 3, CPU)[0]
    assert not control.judged(tiny_cell("int8-encode-384"), 3, CPU)[0]


@pytest.mark.cuda
def test_the_tf32_control_fails_the_f32_limits_on_the_card(card):
    from h100_bench import control

    cell = tiny_cell("f32-sessions-c128")
    cell.config["index"].update(rows=200_000)
    assert not control.judged(cell, 3, card)[0]


def _command(cwd, *extra):
    return subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                           "f32-sessions-c128", "--seed", str(2**33 + 1), "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_with_only_the_benchmark_s_files_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
