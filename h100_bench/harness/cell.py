"""A cell of ``BENCHMARK.json`` and the files it is found by, by name:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<traffic>.json``, the traffic's driver ``drivers/<kind>.py`` and
one reader for each per-layer metric the cell reports: ``metrics/<metric>.py``,
or where there is none, the reader of the name after its first dot (so
``encode.mfu`` is read by ``metrics/mfu.py`` and moves another end-to-end
metric).  Adding a cell, a mix or a metric adds files and entries; no file
here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

_MODULES: Dict[str, ModuleType] = {}


def load_module(path: Path) -> ModuleType:
    """A module from its file (file names may hold dots: ``encode.mfu.py``)."""
    key = str(path.resolve())
    if key not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        spec = importlib.util.spec_from_file_location("h100_bench_file_" + path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    driver: ModuleType
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, ModuleType]


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    """A metric without ``workloads`` is tried in every cell (a reader that
    finds nothing to read leaves it out)."""
    return cell in metric.get("workloads", [cell])


def reader_path(bench: Path, metric: str) -> Path:
    """``metrics/<metric>.py``, else that of the name after its first dot."""
    path = bench / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = bench / "metrics" / f"{metric.split('.', 1)[1]}.py"
    return path


def load_cell(workload: str, root: Path = ROOT, manifest: Optional[Dict] = None) -> Cell:
    manifest = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    conf_entry = configs[w["config"]]
    with open(root / conf_entry["file"]) as f:
        config = json.load(f)
    bench = root / "h100_bench"
    with open(bench / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    driver = load_module(bench / "drivers" / f"{traffic['kind']}.py")
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, workload)]
    readers = {m["name"]: load_module(reader_path(bench, m["name"])) for m in per_layer}
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"], traffic, driver,
                e2e, per_layer, readers)
