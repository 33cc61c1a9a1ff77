"""BENCHMARK.json and the files it names: the contract's form, and a
cell found by name from files alone."""

import json
import re
import shutil

import pytest

from h100_bench.harness.cell import BENCH_DIR, ROOT, load_cell, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_has_the_contract_keys_and_names():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["h100_bench"] and m["command"][1] == "h100_bench/run.py"
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in m[kind]}) == len(m[kind])
    assert len({x["name"] for x in m["end_to_end"] + m["per_layer"]}) == \
        len(m["end_to_end"]) + len(m["per_layer"])
    for x in m["configs"]:
        assert set(x) == {"name", "source", "file", "reduced", "why"}
        assert x["file"].startswith("h100_bench/") and (ROOT / x["file"]).is_file()
    for x in m["workloads"]:
        assert set(x) == {"name", "config", "traffic", "chips", "why"} and x["chips"] == 1
        assert 1 <= len(x["why"]) <= 200
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for x in m["end_to_end"]:
        assert UNIT.match(x["unit"]) and x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25 and x["better"] in ("lower", "higher")
    for x in m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["moves"] in e2e and "bound" not in x
        for cell in x["workloads"]:
            assert cell in CELLS
            moved = e2e[x["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]


def test_every_file_under_the_benchmark_is_named_from_a_names_characters():
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_finds_its_config_traffic_driver_and_readers_by_name(name):
    cell = load_cell(name)
    assert cell.config["index"]["rows"] == 2_500_000
    assert cell.driver.__file__.endswith(f"drivers/{cell.traffic['kind']}.py")
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(callable(r.read) for r in cell.readers.values())


def test_a_cell_added_from_new_files_alone_loads(tmp_path):
    """A later PR's cell: new config, traffic and metric files and new
    entries; no file that is there is edited."""
    shutil.copytree(BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "h100_bench").rglob("*") if p.is_file()}
    m = json.loads(json.dumps(MANIFEST))
    conf = json.loads((BENCH_DIR / "configs" / "ance-f32.json").read_text())
    conf["index"]["rows"] = 1_000_000
    (tmp_path / "h100_bench" / "configs" / "ance-f32-1m.json").write_text(json.dumps(conf))
    mix = json.loads((BENCH_DIR / "traffic" / "sessions-c128.json").read_text())
    mix["clients"] = 256
    (tmp_path / "h100_bench" / "traffic" / "sessions-c256.json").write_text(json.dumps(mix))
    (tmp_path / "h100_bench" / "metrics" / "queries_seen.py").write_text(
        "def read(r):\n    return r.counters.get('queries')\n")
    m["configs"].append({"name": "ance-f32-1m", "source": "x",
                         "file": "h100_bench/configs/ance-f32-1m.json", "reduced": ["index"],
                         "why": "x"})
    m["workloads"].append({"name": "f32-1m-c256", "config": "ance-f32-1m",
                           "traffic": "sessions-c256", "chips": 1, "why": "x"})
    for x in m["end_to_end"]:
        if "workloads" in x and "f32-sessions-c128" in x["workloads"]:
            x["workloads"].append("f32-1m-c256")
    m["per_layer"].append({"name": "queries_seen", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "batcher", "moves": "qps",
                           "workloads": ["f32-1m-c256"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = load_cell("f32-1m-c256", tmp_path)
    assert cell.config["index"]["rows"] == 1_000_000 and cell.traffic["clients"] == 256
    assert "queries_seen" in cell.readers and "embed_ms" not in cell.readers
    assert cell.readers["queries_seen"].read(type("R", (), {"counters": {"queries": 7}})) == 7
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "h100_bench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_a_prefixed_metric_is_read_by_its_own_file_or_that_of_its_plain_name():
    from h100_bench.harness.cell import reader_path

    metrics = BENCH_DIR / "metrics"
    assert reader_path(BENCH_DIR, "encode.mfu") == metrics / "mfu.py"
    assert reader_path(BENCH_DIR, "encode.batch_ms") == metrics / "encode.batch_ms.py"
    assert reader_path(BENCH_DIR, "idle_share") == metrics / "idle_share.py"
    for m in MANIFEST["per_layer"]:
        assert reader_path(BENCH_DIR, m["name"]).is_file(), m["name"]
