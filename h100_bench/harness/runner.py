"""One run of a cell: its traffic module's run, then the result's last line."""

from __future__ import annotations

import math
import subprocess
import sys
from typing import Dict, Tuple

from h100_bench.harness.check import judge

FORBIDDEN = ("jax", "jaxlib", "flax", "haconvdr_tpu")


def forbidden_modules() -> list:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card(device) -> Dict:
    """The card's name and power limit (W) as nvidia-smi reads them."""
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              f"--id={device.index or 0}"], capture_output=True, text=True,
                             timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def _num(v):
    return v if v is None or math.isfinite(v) else None


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> Tuple[Dict, bool]:
    """(the result's line as a dict, correct)."""
    out = cell.driver.run(cell, seed, seconds, trace, device, t_start)
    correct, checks = judge(out["numbers"], cell.config["limits"])
    correct = correct and out["failed"] == 0
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(out["reading"])
            if value is not None:
                metrics[m["name"]] = {"value": _num(float(value)), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": _num(float(out["e2e"][m["name"]])), "unit": m["unit"]}
    device_info = {**card(device), "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    tr = out["reading"].trace
    if trace and tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        line["trace_diagnostics"] = tr.diagnostics
    line["checks"] = checks
    return line, correct
